"""ZipNN on PyTorch and CUDA: lossless compression of model weights, with
the decode kernels written by hand for Hopper (sm_90a).

Layout:
  * :mod:`repro_torch.core` — host codec (ZNN1 container, canonical
    Huffman, byte-group planes), the bytes/tensor/pytree/delta API, the
    ZNS1 file engine and the device encode and decode paths;
  * :mod:`repro_torch.checkpoint` — checkpoints with delta and moment
    chains, and the model-hub transfer model;
  * :mod:`repro_torch.optim` — the optimizer-state keys checkpoints use;
  * :mod:`repro_torch.kernels` — CUDA kernels (``csrc/``) bound with
    ``ctypes``, each beside its plain PyTorch version;
  * :mod:`repro_torch.configs`, :mod:`repro_torch.models` — the dense
    decoder model as plain functions over nested dicts of tensors;
  * :mod:`repro_torch.serve` — the compressed-resident serving ring;
  * :mod:`repro_torch.convert` — params exported as numpy → tensors.

Entry points that touch a device take ``device=`` (default ``"cuda"``)
and raise without a card unless the caller passes ``device="cpu"``.
"""
