"""The one traffic generator: a mix's parameters (`traffic/<mix>.json`)
drive one of the codec's public entry points, as a closed loop with one
client.  The mix names its `kind`; each kind is a module of its own,
`kinds/<kind>.py`, whose `Traffic` class (a `Mix`) owns the kind's set-up,
its call and how its outputs are judged, so a new entry point is one new
file and no existing file changes.

A call returns `(outputs, spans)`: each output answers one image of the
mix (`output_image`); spans are the harness's own (name, start, end) host
intervals around the calls it makes inside one call.
"""

from typing import Dict, List, Optional, Tuple


class Mix:
    """A traffic mix bound to one deployment's codec settings and images.

    `produces` names what an output carries for the comparison:
    "container" (an .ajpg container, judged by its leaves and levels) and
    "image" (decoded pixels, judged against the reference's decode of the
    container they came from)."""

    produces: Tuple[str, ...] = ()

    def __init__(self, at, params: dict, codec_cfg, images, device):
        self.at = at
        self.p = params
        self.cfg = codec_cfg
        self.images = images
        self.device = device
        self.per_call = len(images) * int(params.get("repeat", 1))

    def setup(self) -> None:
        """Work the traffic needs before it can run (not timed as a call)."""

    def call(self) -> Tuple[list, List[tuple]]:
        raise NotImplementedError

    def output_image(self, out, i: int) -> int:
        """The image that output i of a call answers."""
        return i % len(self.images)

    def position(self, i: int) -> int:
        """Output i's place in the call, for the sampler (-1: every output
        of the call answers one request of its own)."""
        return i

    def judged(self, key: int, out) -> Dict[str, object]:
        """An output as the comparison takes it: any of "container",
        "image", and "source", the container "image" was decoded from."""
        raise NotImplementedError

    def source(self, key: int) -> Optional[bytes]:
        """The container the traffic decodes for image `key` when the
        program made it in set-up (for the control to decode)."""
        return None

    def containers(self, outs) -> Optional[list]:
        """The containers whose leaves are the work of `outs`' call."""
        return None

    def release(self) -> None:
        """Drop the program's state."""


def load(reg, codec_cfg, at, traffic: dict, images, device) -> Mix:
    """The mix `traffic` of kind `traffic["kind"]`, found by name."""
    return reg.kind(traffic["kind"])(at, traffic, codec_cfg, images, device)
