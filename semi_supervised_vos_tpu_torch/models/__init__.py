"""ResNet backbones, VOSNet and checkpoint IO (the JAX package's
``models``). ``ResNet`` is the JAX ``ResNetBackbone``; ``state_dict_from_jax``
and ``save_torch_checkpoint`` are the port's own.
Left out: ``convert_vosnet_state_dict`` (torch state dict to flax
variables): the port's modules take the reference's state dict as it is."""

from semi_supervised_vos_tpu_torch.models.convert import (  # noqa: F401
    load_torch_checkpoint,
    save_torch_checkpoint,
    state_dict_from_jax,
)
from semi_supervised_vos_tpu_torch.models.resnet import (  # noqa: F401
    ResNet,
    resnet18,
    resnet34,
    resnet50,
    resnet101,
    resnet152,
)
from semi_supervised_vos_tpu_torch.models.vos_net import VOSNet  # noqa: F401
