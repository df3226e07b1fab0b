"""HEP-BNN on PyTorch and CUDA: the port of the JAX package ``repro``.

Module names mirror ``repro`` (``repro.core.mapper`` <->
``repro_torch.core.mapper``).  The port carries:

* the paper's main path: packed BNN inference (:mod:`repro_torch.bnn`),
  the CPU + 7 aspect-config xnor GEMM and the fused-segment kernel
  (:mod:`repro_torch.kernels`), profiling (measured, autotuned over the
  variant registry, or priced by an analytic H100 model), mapping and
  the plan executor (:mod:`repro_torch.core`), and the serving runtime
  (:mod:`repro_torch.serving`);
* the learned latency estimator and the calibrated interference law
  (:mod:`repro_torch.estimator`);
* the adaptive runtime (:mod:`repro_torch.adapt`), the profile store
  (:mod:`repro_torch.store`) and the cache service
  (:mod:`repro_torch.cachesvc`);
* BNN training: the fp-sim layers and the STE (:mod:`repro_torch.bnn`),
  the train step (:mod:`repro_torch.bnn.train`), optimizers
  (:mod:`repro_torch.optim`), synthetic data (:mod:`repro_torch.data`),
  checkpoints in the JAX package's format (:mod:`repro_torch.ckpt`), the
  fault-tolerant loop (:mod:`repro_torch.runtime`) and trees with JAX's
  leaf order and paths (:mod:`repro_torch.tree`);
* the LM serving path of the attention families: configs
  (:mod:`repro_torch.configs`), the decoder and its steps
  (:mod:`repro_torch.models`, flash attention as a CUDA kernel) and the
  launchers (:mod:`repro_torch.launch`).

Entry points take a ``device``: ``None`` means ``cuda`` and raises
without a card; ``"cpu"`` runs on CPU tensors.
"""

from repro_torch.device import HOST, resolve_device

__all__ = ["HOST", "resolve_device"]
