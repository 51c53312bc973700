"""One call = `encode_stream(images x repeat, cfg, batch_size, lookahead)`:
a user compressing a folder.  Outputs are containers."""

from benchmark.harness.traffic import Mix


class Traffic(Mix):
    produces = ("container",)

    def call(self):
        p = self.p
        out = self.at.encode_stream(
            self.images * p["repeat"], self.cfg, batch_size=p["batch_size"],
            lookahead=p["lookahead"], device=self.device)
        return out, []

    def judged(self, key, out):
        return {"container": out}

    def containers(self, outs):
        return list(outs[:len(self.images)])
