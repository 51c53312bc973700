"""The readers of the hysteresis's banded path (`encode.hysteresis_rounds`,
`encode.hysteresis_wait_ms`) on hand-built span records, and None from a
window without them; the metrics the two new cells report."""

from types import SimpleNamespace

import pytest

from benchmark.harness.registry import Registry

NEW = ("encode.hysteresis_rounds", "encode.hysteresis_wait_ms")


def _read(name, events):
    return Registry().metric_reader(name)(SimpleNamespace(events=events))


def _span(i, name, parent, start, end, **counts):
    return {"event": "span", "name": name, "id": i, "parent": parent,
            "root": 1, "thread": 7, "start_ns": start * 10 ** 6,
            "end_ns": end * 10 ** 6, "cpu_ns": None, "counts": counts,
            "attrs": {}}


def _batch(b, groups):
    """An encode batch whose stage A holds one `stage_a.canny` span a
    group: (rounds or None for the resident path, [check ms])."""
    ev = [_span(b, "encode.batch", 1, b, b + 90),
          _span(b + 1, "encode.stage_a", b, b, b + 90)]
    for g, (rounds, waits) in enumerate(groups):
        c = b + 10 * (g + 1)
        counts = {"hysteresis_checks": len(waits)}
        if rounds is not None:
            counts.update(hysteresis_rounds=rounds, hysteresis_bands=4)
        ev.append(_span(c, "stage_a.canny", b + 1, c, c + 9, **counts))
        t = c
        for k, w in enumerate(waits):
            ev.append(_span(c + 1 + k, "sync.hysteresis", c, t, t + w,
                            sync=1))
            t += w
    return ev


def test_readers_by_hand():
    """Three batches: a banded luma group and a resident chroma group
    each; the medians of the batches' sums."""
    ev = (_batch(100, [(3, [2]), (None, [])])
          + _batch(200, [(5, [1, 3]), (None, [])])
          + _batch(300, [(4, [2]), (None, [])]))
    assert _read("encode.hysteresis_rounds", ev) == pytest.approx(4.0)
    assert _read("encode.hysteresis_wait_ms", ev) == pytest.approx(2.0)


def test_groups_of_a_batch_are_summed():
    ev = _batch(100, [(3, [2]), (6, [1, 4])])
    assert _read("encode.hysteresis_rounds", ev) == pytest.approx(9.0)
    assert _read("encode.hysteresis_wait_ms", ev) == pytest.approx(7.0)


@pytest.mark.parametrize("name", NEW)
def test_readers_find_nothing_without_the_banded_path(name):
    """Every plane resident (no rounds, no checks), batch events alone, or
    no records: None."""
    resident = _batch(100, [(None, []), (None, [])])
    events = [{"event": "encode_batch", "ts": 2.0, "wall_s": 1.0,
               "stages": {"push": 0.5, "stage_a": 0.5}}]
    for ev in (resident, events, []):
        assert _read(name, ev) is None


def test_a_program_without_the_rounds_count():
    """A program whose banded path checks but counts no rounds (the count
    is newer than the checks) reads its waits and no rounds."""
    ev = _batch(100, [(None, [2, 1])])
    assert _read("encode.hysteresis_rounds", ev) is None
    assert _read("encode.hysteresis_wait_ms", ev) == pytest.approx(3.0)


def test_spec_lists_the_cells_metrics():
    reg = Registry()
    spec = reg.spec()
    per_layer = {m["name"]: m for m in spec["per_layer"]}
    for name in NEW:
        assert per_layer[name]["workloads"] == ["clic.encode-stream"]
        assert callable(reg.metric_reader(name))
    clic = {m["name"] for m in reg.metrics_of("clic.encode-stream", True)}
    assert set(NEW) <= clic and len(clic) == 12
    compress = {m["name"] for m in reg.metrics_of("kodak.compress", True)}
    assert compress == {"encode.push_ms.compress",
                        "encode.stage_a_ms.compress",
                        "encode.assemble_ms.compress",
                        "idle_share.compress"}
    for cell in ("clic.encode-stream", "kodak.compress"):
        assert {m["name"] for m in reg.metrics_of(cell, False)} == {
            "encode_mpix_s", "setup_s"}
