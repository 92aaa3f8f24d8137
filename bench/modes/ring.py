"""Serving mode ``ring``: the compressed-resident ring.  The layer stacks
live on the card as ZNN1 payloads in a ``CompressedParamStore`` built with
the settings the port serves with (Huffman, the build on the card, payload
feeds with K1's sync index); the step of ``make_compressed_serve_step`` at
its defaults (ring 2, tiles 1) decodes each layer (K1's sync decode, then
K2) just ahead of its compute.  Once the store is built no plain copy of
the stacks stays on the card."""

from repro_torch.core import zipnn
from repro_torch.core.options import CodecOptions
from repro_torch.serve import CompressedParamStore, make_compressed_serve_step


def setup(cfg, params, device):
    store = CompressedParamStore.from_params(
        params, zipnn.ZipNNConfig(backend="huffman"),
        options=CodecOptions(threads=-1, backend="device"), payload_feed=True, device=device)
    return Ring(cfg, store)


class Ring:
    def __init__(self, cfg, store):
        self.store = store
        self.step = make_compressed_serve_step(cfg, store)

    def counters(self):
        s = self.store
        return {"device_payload_bytes": s.device_payload_bytes, "raw_bytes": s.raw_bytes,
                "comp_bytes": s.comp_bytes, "static_bytes": s.static_bytes}

    def instrument(self, span):
        """Wrap the store's decode calls in ``span()`` on this instance;
        returns the undo."""
        names = ("decode_layer", "decode_layer_tile")

        def wrap(fn):
            def inner(*args, **kwargs):
                with span():
                    return fn(*args, **kwargs)
            return inner

        for n in names:
            setattr(self.store, n, wrap(getattr(self.store, n)))

        def undo():
            for n in names:
                delattr(self.store, n)
        return undo
