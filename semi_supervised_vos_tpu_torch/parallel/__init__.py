"""Multi-device inference on one process: a mesh of devices, collectives
over per-shard tensors, the bank-sharded affinity and engines. JAX's
``data_sharding`` / ``replicated`` have no counterpart (see ``mesh.py``)."""

from semi_supervised_vos_tpu_torch.parallel import collectives  # noqa: F401
from semi_supervised_vos_tpu_torch.parallel.mesh import Mesh, make_mesh  # noqa: F401
from semi_supervised_vos_tpu_torch.parallel.sharded_affinity import sharded_affinity_propagate  # noqa: F401
