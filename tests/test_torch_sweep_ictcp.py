"""The port's batched metric sweep in ICtCp against its own encode_batch ->
decode_batch -> EvaluationMetrics path: test_torch_sweep.py's case of this
space, in a file of its own so that no one file of the sweep tests sets
the wall of a parallel run."""

import pytest

from test_torch_sweep import check_sweep_matches_decode_path, files  # noqa: F401


@pytest.mark.parametrize("space", ["ICtCp"])
def test_sweep_matches_decode_path(files, tmp_path, space):
    check_sweep_matches_decode_path(files, tmp_path, space)
