"""One call = `decode_stream(containers x repeat, batch_size, lookahead)`,
images back on the host: a user decompressing a folder.  The containers
are made once in set-up by `encode_stream`; outputs are images."""

from benchmark.harness.traffic import Mix


class Traffic(Mix):
    produces = ("image",)
    blobs = None

    def setup(self):
        self.blobs = self.at.encode_stream(
            self.images, self.cfg, batch_size=self.p["batch_size"],
            lookahead=self.p["lookahead"], device=self.device)

    def call(self):
        p = self.p
        out = self.at.decode_stream(
            self.blobs * p["repeat"], batch_size=p["batch_size"],
            lookahead=p["lookahead"], device=self.device)
        return out, []

    def judged(self, key, out):
        return {"image": out, "source": self.blobs[key]}

    def source(self, key):
        return self.blobs[key]

    def containers(self, outs):
        return list(self.blobs)

    def release(self):
        self.blobs = None
