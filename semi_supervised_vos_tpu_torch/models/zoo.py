"""Model-zoo lookup behind ``train --pretrained``'s default: the port's copy
of the JAX package's ``models/zoo.py``.

The reference initialises its backbone from torchvision's ImageNet weights
at construction (``src/model/backbone/resnet.py:13-19,159-171``). Here, when
``--pretrained`` is not given, :func:`auto_pretrained_path` looks in the
cache first, then tries the zoo URL; offline it returns ``None`` and training
starts from random initialisation. ``SVOS_ZOO=0`` turns the lookup off (the
tests and ``chip_smoke.py`` set it). The ``layer4.*`` / ``fc.*`` drop
(``fc.*`` only for facebook) is in
:func:`semi_supervised_vos_tpu_torch.models.convert.load_torchvision_backbone`.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional

from semi_supervised_vos_tpu_torch.utils.logging import logger

# torchvision model-zoo URLs, as in the reference (resnet.py:13-19); the
# facebook variant's swsl resnet50, which the reference takes from
# torch.hub (vos_net.py:29-38), at the direct URL the hub entry resolves to
MODEL_ZOO_URLS = {
    "resnet18": "https://download.pytorch.org/models/resnet18-5c106cde.pth",
    "resnet50": "https://download.pytorch.org/models/resnet50-19c8e357.pth",
    "resnet101": "https://download.pytorch.org/models/resnet101-5d3b4d8f.pth",
    "facebook": "https://dl.fbaipublicfiles.com/semiweaksupervision/"
    "model_files/semi_weakly_supervised_resnet50-16a12f1b.pth",
}


def _cache_dir() -> Path:
    return Path(os.environ.get("SVOS_ZOO_DIR") or Path.home() / ".cache" / "svos_model_zoo")


def _hash_ok(path: Path, name: Optional[str] = None) -> bool:
    """torchvision zoo file names embed a sha256 prefix (``name-<hex>.pth``);
    check it where the name (``name`` overrides ``path``'s) has one."""
    import hashlib
    import re

    m = re.search(r"-([0-9a-f]{8,})\.pth$", name or path.name)
    if m is None:
        return True
    digest = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            digest.update(block)
    return digest.hexdigest().startswith(m.group(1))


def fetch_pretrained(model: str, url: Optional[str] = None, cache_dir: Optional[os.PathLike] = None,
                     timeout: float = 60.0) -> Optional[str]:
    """A local path to ``model``'s ImageNet checkpoint, or None.

    URL: ``url`` > ``SVOS_ZOO_URL_<MODEL>`` > ``SVOS_ZOO_URL`` > the table
    above (a mirror's file is cached under the model's name too). A cached
    file that passes its hash check is returned without a download; a
    download lands in the cache (``SVOS_ZOO_DIR`` or ~/.cache/svos_model_zoo)
    through a temporary file. Any failure returns None. ``file://`` URLs
    work."""
    import shutil
    import tempfile
    import urllib.parse
    import urllib.request

    env_url = os.environ.get(f"SVOS_ZOO_URL_{model.upper()}") or os.environ.get("SVOS_ZOO_URL")
    url = url or env_url or MODEL_ZOO_URLS.get(model)
    if url is None:
        return None
    cache = Path(cache_dir) if cache_dir is not None else _cache_dir()
    name = Path(urllib.parse.urlparse(url).path).name or f"{model}.pth"
    if url not in MODEL_ZOO_URLS.values():
        name = f"{model}-{name}"
    dest = cache / name
    if dest.exists():
        if _hash_ok(dest):
            return str(dest)
        logger.warning(f"Cached {dest} fails its hash check; re-fetching.")
        dest.unlink()
    cache.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".part", dir=cache)
    try:
        with os.fdopen(fd, "wb") as f, urllib.request.urlopen(url, timeout=timeout) as r:
            shutil.copyfileobj(r, f)
        if not _hash_ok(Path(tmp), name=dest.name):
            raise OSError("downloaded file fails its embedded sha256 prefix")
        os.replace(tmp, dest)
        logger.info(f"Fetched pretrained weights: {url} -> {dest}")
        return str(dest)
    except Exception as e:  # offline, DNS, 404, permissions: all fall back
        Path(tmp).unlink(missing_ok=True)
        logger.warning(f"Could not fetch pretrained weights from {url} ({e}); continuing without.")
        return None


def auto_pretrained_path(model: str) -> Optional[str]:
    """``--pretrained``'s default: the zoo, cache first, or None (random
    initialisation). ``SVOS_ZOO=0`` skips the lookup."""
    if os.environ.get("SVOS_ZOO", "1") == "0":
        return None
    path = fetch_pretrained(model)
    if path is None:
        logger.info("No pretrained backbone available (offline and nothing cached); training from random init. "
                    "Pass --pretrained <file> or set SVOS_ZOO_URL.")
    return path
