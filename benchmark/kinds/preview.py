"""One request = `Codec.compress(image)` then `Codec.decompress(blob)` on
one `Codec` built in set-up, cycling through the images with no think
time: the GUI's preview.  An output is (image index, container, image)."""

import time

from benchmark.harness.traffic import Mix


class Traffic(Mix):
    produces = ("container", "image")
    codec = None
    turn = 0

    def __init__(self, *args):
        super().__init__(*args)
        self.per_call = 1

    def setup(self):
        self.codec = self.at.Codec(self.cfg, device=self.device)

    def call(self):
        k = self.turn % len(self.images)
        self.turn += 1
        t0 = time.time()
        blob = self.codec.compress(self.images[k])
        t1 = time.time()
        img = self.codec.decompress(blob)
        t2 = time.time()
        return [(k, blob, img)], [("preview.compress", t0, t1),
                                  ("preview.decompress", t1, t2)]

    def output_image(self, out, i):
        return out[0]

    def position(self, i):
        return -1

    def judged(self, key, out):
        return {"container": out[1], "image": out[2], "source": out[1]}

    def release(self):
        self.codec = None
