"""3xTF32, the float32 kernels' arithmetic on the tf32 tensor cores, on the
CPU: a torch emulation of ``cvt.rna.tf32.f32`` and of the three-term
product holds the bank affinity and the bottleneck to the card's float32
gates against a float64 reference (one tf32 product is recorded beside
it, without a gate, to show why three are needed), and the fold-time
K-major ``big`` / ``small`` weight planes of ``csrc/bottleneck_f32.cu``
reassemble to the folded weights, entry by entry, for resnet50 and
facebook, whose float32 folds still match the JAX package's and copy to
every device of a mesh."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from semi_supervised_vos_tpu.models.fold import fold_vosnet as jax_fold_vosnet
from semi_supervised_vos_tpu_torch.core.sampling import sample_frames
from semi_supervised_vos_tpu_torch.models.fold import fold_vosnet
from semi_supervised_vos_tpu_torch.ops import affinity as tap
from semi_supervised_vos_tpu_torch.ops.bottleneck import TF32Planes, tf32_round
from semi_supervised_vos_tpu_torch.parallel.mesh import make_mesh, replicate
from tests.test_torch_models import jax_variables, port_net

AFFINITY_GATE = 3.4e-5  # the card's float32 bank-kernel gate (chip_smoke.py phase 14a)
BOTTLENECK_GATE = 1e-4  # of the largest output (chip_smoke.py phase 14b)


def split(x: torch.Tensor):
    """x (float32) → (big, small): both tf32 values, as the kernels split."""
    big = tf32_round(x)
    return big, tf32_round(x - big)


def matmul_tf32x3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the kernels compute it: small · big + big · small + big · big
    of tf32 operands (each product exact in float32), accumulated in
    float32."""
    (ab, asm), (bb, bsm) = split(a), split(b)
    return asm @ bb + ab @ bsm + ab @ bb


def matmul_tf32x1(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One tf32 product (what TF32 mode computes), for comparison."""
    return tf32_round(a) @ tf32_round(b)


def test_tf32_round_is_cvt_rna():
    """Round to nearest, ties away from zero, on the 13 low mantissa bits."""
    one = 1.0 + 2.0**-11  # exactly half a tf32 ulp above 1
    x = torch.tensor([one, -one, 1.0 + 2.0**-12, 3.0, 0.0, -2.5e-30], dtype=torch.float32)
    got = tf32_round(x)
    assert got.tolist()[:4] == [1.0 + 2.0**-10, -(1.0 + 2.0**-10), 1.0, 3.0]
    assert got[4] == 0 and got[5] < 0
    r = torch.as_tensor(np.random.default_rng(0).standard_normal(100_000), dtype=torch.float32)
    big, small = split(r)
    assert not (big.view(torch.int32) & 0x1FFF).any() and not (small.view(torch.int32) & 0x1FFF).any()
    assert ((r - big).abs() <= 2.0**-11 * r.abs()).all()
    assert ((r.double() - big.double() - small.double()).abs() <= 2.0**-22 * r.abs().double()).all()


def _bank_case(seed: int, hd: int, wd: int):
    """The main path's statistics (chip_smoke.py phase 14a): K 9 sampled
    slots of a 45-slot bank, C 256, features and target ~ N(0, 0.2²), 22
    one-hot classes in 24 columns, the prior on."""
    rng = np.random.default_rng(seed)
    c, d, d_pad, cap, k = 256, 22, 24, 45, 9
    p = hd * wd
    feats = torch.as_tensor(rng.standard_normal((cap, 1, p, c)) * 0.2, dtype=torch.float32)
    labels = F.one_hot(torch.as_tensor(rng.integers(0, d, (cap, 1, p))), d_pad).float()
    tgt = torch.as_tensor(rng.standard_normal((1, p, c)) * 0.2, dtype=torch.float32)
    idx, valid, dense = sample_frames(50, 40, k)
    return feats, labels, tgt, idx % cap, valid, dense, d


def _propagate(feats, labels, tgt, slots, valid, dense, hd, wd, sim, dtype):
    """The bank affinity's function (softmax over the K·P rows, prior after
    it, label product) with the similarity from ``sim(ref, tgt)`` and the
    rest in ``dtype``."""
    _, inv_sigma2, bias = tap.slot_table(slots, valid, dense, 8.0, 21.0, True)
    idx = torch.as_tensor(slots, dtype=torch.long)
    ref = feats.index_select(0, idx)[:, 0]  # (K, P, C)
    s = torch.stack([sim(r, tgt[0].T) for r in ref]).to(dtype)  # (K, P_ref, P)
    s = s + torch.as_tensor(bias, dtype=dtype)[:, None, None]
    e = torch.exp(s - s.amax(dim=(0, 1), keepdim=True))
    p = hd * wd
    q = torch.arange(p, dtype=dtype)
    dy = q[:, None] / wd - q[None, :] / wd
    dx = (q % wd)[:, None] - (q % wd)[None, :]
    w = torch.exp(-(dy * dy + dx * dx)[None] * torch.as_tensor(inv_sigma2, dtype=dtype)[:, None, None])
    lab = labels.index_select(0, idx)[:, 0].to(dtype)  # (K, P, D)
    return torch.einsum("krd,krq->dq", lab, e * w) / e.sum(dim=(0, 1))


@pytest.mark.parametrize("seed,hd,wd", [(0, 12, 16), (1, 9, 27)])
def test_bank_affinity_tf32x3_meets_the_float32_gate(record_property, seed, hd, wd):
    """3xTF32 similarity (float32 softmax and label product) against the
    float64 reference: within the card's 3.4e-5 with argmax 1.0. One tf32
    product's error is recorded beside it (no gate)."""
    case = _bank_case(seed, hd, wd)
    *inputs, d = case
    ref = _propagate(*inputs, hd, wd, lambda a, b: a.double() @ b.double(), torch.float64)[:d]
    got = _propagate(*inputs, hd, wd, matmul_tf32x3, torch.float32)[:d].double()
    one = _propagate(*inputs, hd, wd, matmul_tf32x1, torch.float32)[:d].double()
    err3, err1 = (got - ref).abs().max().item(), (one - ref).abs().max().item()
    record_property("max_abs_tf32x3", err3)
    record_property("max_abs_tf32x1", err1)
    assert err3 <= AFFINITY_GATE
    assert (got.argmax(0) == ref.argmax(0)).all()
    assert err3 < err1  # three products against one: the reason for three


def _bottleneck(x, w1, b1, w2, b2, w3, b3, mm, dtype):
    """The fused block's function, NHWC, each product through ``mm`` and the
    rest in ``dtype``: relu(relu(conv3x3(relu(x W1 + b1)) + b2) W3 + b3 + x)."""
    n, h, w, c = x.shape
    c4 = w1.shape[1]
    y1 = torch.relu(mm(x.reshape(-1, c), w1).to(dtype) + b1.to(dtype)).reshape(n, h, w, c4)
    cols = F.unfold(y1.permute(0, 3, 1, 2), 3, padding=1)  # (N, C4 * 9, H W), channel-major
    cols = cols.reshape(n, c4, 9, h * w).permute(0, 3, 2, 1).reshape(-1, 9 * c4)  # (N H W, tap · C4)
    k2 = w2.reshape(9 * c4, c4)  # HWIO: (tap · C4_in, C4_out)
    y2 = torch.relu(mm(cols.float(), k2).to(dtype) + b2.to(dtype))
    y3 = mm(y2.float(), w3).to(dtype) + b3.to(dtype) + x.reshape(-1, c).to(dtype)
    return torch.relu(y3).reshape(n, h, w, c)


@pytest.mark.parametrize("c,c4", [(512, 128), (1024, 256)])
def test_bottleneck_tf32x3_meets_the_float32_gate(record_property, c, c4):
    """The float32 bottleneck with 3xTF32 products at resnet50's widths
    (He-scaled weights, a post-ReLU input) against the float64 reference:
    within 1e-4 of the largest output, the card's gate. One tf32 product's
    error is recorded beside it (no gate)."""
    rng = np.random.default_rng(c)
    x = torch.as_tensor(np.maximum(rng.standard_normal((1, 6, 7, c)), 0), dtype=torch.float32)
    shapes = [(c, c4), (c4,), (3, 3, c4, c4), (c4,), (c4, c), (c,)]
    scales = [np.sqrt(2 / c), 0.1, np.sqrt(2 / (9 * c4)), 0.1, np.sqrt(2 / c4), 0.1]
    wts = [torch.as_tensor(rng.standard_normal(s) * sc, dtype=torch.float32) for s, sc in zip(shapes, scales)]
    ref = _bottleneck(x.double(), *[w.double() for w in wts], lambda a, b: a.double() @ b.double(), torch.float64)
    got = _bottleneck(x, *wts, matmul_tf32x3, torch.float32).double()
    one = _bottleneck(x, *wts, matmul_tf32x1, torch.float32).double()
    rel3 = ((got - ref).abs().max() / ref.abs().max()).item()
    rel1 = ((one - ref).abs().max() / ref.abs().max()).item()
    record_property("rel_tf32x3", rel3)
    record_property("rel_tf32x1", rel1)
    assert rel3 <= BOTTLENECK_GATE
    assert rel3 < rel1


@pytest.fixture(scope="module", params=["resnet50", "facebook"])
def folded(request):
    arch = request.param
    jnet, variables = jax_variables(arch, 3)
    net = port_net(arch, variables)
    with torch.no_grad():
        table = fold_vosnet(net, torch.float32)
    return arch, variables, table


def test_fold_planes_reassemble_to_the_folded_weights(folded):
    """Each ``fused_tf32`` entry: K-major (out, in) planes, ``big`` and
    ``small`` tf32 values whose sum is the folded weight within 2^-21 of it,
    entry by entry: w1[in, out], w2[dy, dx, in, out] at tap 3 dy + dx, w3[in,
    out]. Only the float32 kernel's widths (C4 128, 256) have planes."""
    arch, _, table = folded
    fused = sorted(k.split("/")[0] for k in table if k.endswith("/fused_tf32"))
    assert len(fused) == {"resnet50": 11, "facebook": 8}[arch]
    for name in (k.split("/")[0] for k in table if k.endswith("/fused")):
        assert (name in fused) == (table[f"{name}/fused"][0].shape[1] in (128, 256))
    for name in fused:
        w1, _, w2, _, w3, _ = table[f"{name}/fused"]
        planes = table[f"{name}/fused_tf32"]
        c, c4 = w1.shape
        assert tuple(planes.w1.shape) == (2, c4, c) and tuple(planes.w2.shape) == (2, 9, c4, c4)
        assert tuple(planes.w3.shape) == (2, c, c4)
        for got, want in ((planes.w1, w1.T), (planes.w3, w3.T),
                          (planes.w2, w2.permute(0, 1, 3, 2).reshape(9, c4, c4))):
            assert got.dtype == torch.float32 and got.is_contiguous()
            assert not (got.view(torch.int32) & 0x1FFF).any()  # both planes are tf32 values
            assert ((got[0] + got[1] - want).abs() <= 2.0**-21 * want.abs()).all()
        # spot entries by index: tap 3 dy + dx, output o, input i
        for dy, dx, i, o in ((0, 0, 0, 1), (1, 2, c4 - 1, 0), (2, 1, 3, c4 - 2)):
            assert abs(planes.w2[0, 3 * dy + dx, o, i] + planes.w2[1, 3 * dy + dx, o, i] - w2[dy, dx, i, o]) <= (
                2.0**-21 * abs(w2[dy, dx, i, o]))
        assert planes.w1[0, 5, 7] + planes.w1[1, 5, 7] == pytest.approx(float(w1[7, 5]), rel=2.0**-21)
        assert planes.w3[0, 9, 2] + planes.w3[1, 9, 2] == pytest.approx(float(w3[2, 9]), rel=2.0**-21)


def test_float32_fold_still_matches_jax(folded):
    """The float32 table's fused operands (w1, b1, w2, b2, w3, b3) equal the
    JAX package's float32 fold of the same variables, as before planes were
    added beside them."""
    arch, variables, table = folded
    jtable = jax_fold_vosnet(variables, arch, np.float32)
    names = sorted(k.split("/")[0] for k in table if k.endswith("/fused"))
    assert names
    for name in names:
        w1, b1, w2, b2, w3, b3 = (t.numpy() for t in table[f"{name}/fused"])
        for got, key in ((w1, "conv1/kernel"), (b1, "conv1/bias"), (w2, "conv2/kernel"), (b2, "conv2/bias"),
                         (w3, "conv3/kernel"), (b3, "conv3/bias")):
            want = np.asarray(jtable[f"{name}/{key}"]).reshape(got.shape)
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7, err_msg=f"{name}/{key}")


def test_float32_fold_replicates_over_a_mesh(folded):
    """The float32 table, its ``TF32Planes`` named tuples included, copies
    to every device of a mesh as the lockstep mesh runner does (a virtual
    mesh naming the CPU twice): every entry keeps its type and values."""
    _, _, table = folded
    mesh = make_mesh(1, 2, devices=[torch.device("cpu")] * 2)
    (copy,) = replicate(mesh, table).values()
    assert copy.keys() == table.keys()
    for key, value in table.items():
        assert type(copy[key]) is type(value), key
        if isinstance(value, TF32Planes):
            assert all(torch.equal(a, b) for a, b in zip(copy[key], value)), key
