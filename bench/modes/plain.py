"""Serving mode ``plain``: the port's plain decode step
(``serve.make_serve_step``, which is ``models.decode_step``) over the
weights as they were drawn, the way most users of ZipNN serve: the
checkpoint decompressed once at load.  No weight decode runs."""

from repro_torch.serve import make_serve_step


def setup(cfg, params, device):
    return Plain(cfg, params)


class Plain:
    def __init__(self, cfg, params):
        self.params = params
        self._step = make_serve_step(cfg)

    def step(self, state, tokens):
        return self._step(self.params, state, tokens)

    def counters(self):
        return {}

    def instrument(self, span):
        """Nothing decodes weights here: no decode spans."""
        return lambda: None
