"""ZipNN on PyTorch and CUDA: lossless compression of model weights, with
the decode kernels written by hand for Hopper (sm_90a).

Layout:
  * :mod:`repro_torch.core` — host codec (ZNN1 container, canonical
    Huffman, byte-group planes), the bytes/tensor/pytree/delta API, the
    ZNS1 file engine and the device encode and decode paths;
  * :mod:`repro_torch.checkpoint` — checkpoints with delta and moment
    chains, and the model-hub transfer model;
  * :mod:`repro_torch.optim` — AdamW (schedule, state, update) and the
    optimizer-state keys checkpoints chain;
  * :mod:`repro_torch.kernels` — CUDA kernels (``csrc/``) bound with
    ``ctypes``, each beside its plain PyTorch version;
  * :mod:`repro_torch.configs`, :mod:`repro_torch.models` — the six
    model families as plain functions over nested dicts of tensors
    (forward, training loss with its custom backward passes, decode);
  * :mod:`repro_torch.serve` — the compressed-resident serving ring;
  * :mod:`repro_torch.train`, :mod:`repro_torch.launch` — the train step,
    and the training and serving entry points;
  * :mod:`repro_torch.distributed` — compressed gradient exchange;
  * :mod:`repro_torch.data` — the deterministic synthetic batches;
  * :mod:`repro_torch.convert` — params and train states exported as
    numpy → tensors.

Entry points that touch a device take ``device=`` (default ``"cuda"``)
and raise without a card unless the caller passes ``device="cpu"``.
"""
