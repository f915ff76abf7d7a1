"""The per-video propagation engine (the JAX package's ``infer``, every
name it exports); the lockstep engine is ``infer/batched.py``, the seven
strategies ``infer/strategies.py``."""

from semi_supervised_vos_tpu_torch.infer.engine import BankState, EngineConfig, PropagationEngine  # noqa: F401
