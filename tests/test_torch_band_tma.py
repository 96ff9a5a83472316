"""The bf16 K1 stage's TMA-fed wgmma kernel (``csrc/band_wgmma.cu``,
``tt_band_conv_wgmma``) on the CPU: its box and tile plan
(``band_tma_plan``), the zero padding of a ragged T (``tma_frames``) and
the routing of ``banded_conv``.

There is no card here, so an emulation walks the plan exactly as the
kernel does: per output tile (one 64-row sub-tile x 128 frames) and tap,
zero-filled boxes of 136 frames at the tap's box offset, chunk by chunk
and k16 step by k16 step into float32 sums, the tap's sums shifted by its
shift into the tile's, then bias, ELU, residual and the rounding to the
storage dtype. It is held against the plain twin (``banded_conv_reference``)
stage by stage and as the small geometry's whole chain (the twin chain is
held against the JAX package's Pallas chain by
``tests/test_torch_packed.py``), and against the JAX package's
``packed_conv_reference`` on two flagship stages. The kernel itself is
held against the twin on the card (``tests/test_torch_kernels.py``,
``chip_smoke.py``).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from timbre_trap_tpu.ops import packed_conv as jpc
from timbre_trap_tpu_torch.models import TimbreTrapNet, forward_spec
from timbre_trap_tpu_torch.models.fused import fused_forward
from timbre_trap_tpu_torch.models.modules import init_weights
from timbre_trap_tpu_torch.ops import fused_level as fl
from timbre_trap_tpu_torch.ops import packed_conv as pc
from timbre_trap_tpu_torch.utils import profiling

torch.set_num_threads(2)


def _rand(rng, *shape, scale=1.0):
    return torch.from_numpy(_np_rand(rng, *shape, scale=scale))


def _np_rand(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _boxes(xp, rows, frames):
    """x[:, rows][:, :, frames] with zeros outside the tensor, as the
    tensor map's edge fill gives them."""
    r_in, t_pad = xp.shape[1], xp.shape[2]
    ok = (((rows >= 0) & (rows < r_in))[:, None, None]
          & ((frames >= 0) & (frames < t_pad))[None])
    got = xp[:, rows.clamp(0, r_in - 1)][:, :, frames.clamp(0, t_pad - 1)]
    return got * ok


def emulate_wgmma(x, cb, act=False, residual=None):
    """``tt_band_conv_wgmma``'s arithmetic on the CPU, in the kernel's
    order of sums (tap, chunk, k16 step; the taps' sums added in tap order
    into a zero tile)."""
    b, r_in, t = x.shape
    plan = fl.band_tma_plan(cb, t)
    xp = fl.tma_frames(x, plan.t_pad).to(torch.float32)
    w, bias = cb.band_operands(x.dtype)
    w = w.to(torch.float32)
    tile, span = fl.WGMMA_TILE_T, fl.WGMMA_TILE_T + fl.WGMMA_EDGE_T
    starts = torch.arange(plan.tiles)[:, None] * tile
    y = torch.zeros((b, plan.n_sub * pc.SUB_ROWS, plan.tiles * tile))
    for g in range(plan.n_sub):
        start, length, chunks = plan.bands[g % 2]
        row0 = cb.sub_start(g)
        wg = w[cb.sub_weights(g)]
        out = torch.zeros((b, pc.SUB_ROWS, plan.tiles, tile))
        for tap, (off, shift) in enumerate(plan.taps):
            frames = starts + off + torch.arange(span)[None]
            acc = torch.zeros((b, pc.SUB_ROWS, plan.tiles, span))
            for c in range(chunks):
                steps = min(fl.WGMMA_KC // 16,
                            (length - c * fl.WGMMA_KC) // 16)
                for ks in range(steps):
                    k0 = c * fl.WGMMA_KC + 16 * ks
                    box = _boxes(xp, row0 + k0 + torch.arange(16), frames)
                    acc += torch.einsum("rk,bkjn->brjn",
                                        wg[tap, :, k0:k0 + 16], box)
            out += acc[..., shift:shift + tile]
        y[:, g * pc.SUB_ROWS:(g + 1) * pc.SUB_ROWS] = out.reshape(
            b, pc.SUB_ROWS, -1)
    y = y[:, :cb.r_out, :t]
    rows = torch.arange(cb.r_out)
    y = y + bias[rows % bias.numel()][None, :, None]
    if act:
        y = torch.where(y > 0, y, torch.exp(torch.clamp(y, max=0.0)) - 1.0)
    if residual is not None:
        y = y + residual.to(torch.float32)
    return y.to(x.dtype)


def _close(got, want, tol, what):
    err = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    assert err <= tol * scale, (what, err, scale)


@pytest.fixture(scope="module")
def small_net():
    """The port's net at the small geometry (F=60, latent 16, complexity
    1), seeded."""
    return init_weights(TimbreTrapNet(60, 16, 1),
                        torch.Generator().manual_seed(3))


def _flagship_stage_args():
    """Builder and numpy arguments of two flagship stage kinds: a residual
    3x3 conv at dilation 3 (taps -3, 0, 3 on 2160 rows) and the dense
    bridge 1984 -> 128 (one band of all 1984 columns)."""
    rng = np.random.default_rng(21)
    return {"3x3-d3": ("build_conv2d_blocks",
                       (_np_rand(rng, 3, 3, 4, 4), _np_rand(rng, 4), 540, 3)),
            "bridge": ("build_dense_blocks",
                       (_np_rand(rng, 128, 1984, scale=0.03),
                        _np_rand(rng, 128)))}


def _flagship_stages():
    return {kind: getattr(pc, fn)(*[torch.from_numpy(a)
                                    if isinstance(a, np.ndarray) else a
                                    for a in args])
            for kind, (fn, args) in _flagship_stage_args().items()}


@pytest.mark.parametrize("t", [40, 37])
def test_emulation_matches_twin_on_small_geometry(small_net, t):
    """Every stage of the small geometry's forward chain, alone, on random
    input (residual where the stage may take one): the emulated kernel
    within 1e-5 * max|ref| of the twin in float32 (sum order only) and
    within 1e-2 * max|ref| in bf16 (sum order and the output rounding, the
    card's bar)."""
    rng = np.random.default_rng(t)
    convs = list(forward_spec(small_net, True).convs())
    assert len(convs) > 20
    for i, cb in enumerate(convs):
        x = _rand(rng, 2, cb.r_in, t)
        res = None if cb.col_adv == 0 else _rand(rng, 2, cb.r_out, t)
        for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 1e-2)):
            r = None if res is None else res.to(dtype)
            _close(emulate_wgmma(x.to(dtype), cb, True, r),
                   fl.banded_conv_reference(x.to(dtype), cb, True, r), tol,
                   (i, cb.dts, cb.bands, dtype))


@pytest.mark.parametrize("t", [40, 37])
@pytest.mark.parametrize("kind", ["3x3-d3", "bridge"])
def test_emulation_matches_twin_on_flagship_stages(kind, t):
    """The same on two flagship stage kinds at narrow T."""
    cb = _flagship_stages()[kind]
    rng = np.random.default_rng(len(kind) + t)
    x = _rand(rng, 1, cb.r_in, t)
    res = None if cb.col_adv == 0 else _rand(rng, 1, cb.r_out, t)
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 1e-2)):
        r = None if res is None else res.to(dtype)
        _close(emulate_wgmma(x.to(dtype), cb, True, r),
               fl.banded_conv_reference(x.to(dtype), cb, True, r), tol,
               (kind, dtype))


@pytest.mark.parametrize("kind", ["3x3-d3", "bridge"])
def test_emulation_matches_jax_packed_conv(kind):
    """Two flagship stages built from the same numpy weights in both
    packages: the emulated kernel (float32, no ELU or residual) within
    1e-5 * max|ref| of the JAX package's ``packed_conv_reference``, the
    plain XLA execution of the TPU kernel's banded stage."""
    fn, args = _flagship_stage_args()[kind]
    cb = _flagship_stages()[kind]
    x = _np_rand(np.random.default_rng(4), 1, cb.r_in, 40)
    want = np.asarray(jpc.packed_conv_reference(jnp.asarray(x),
                                                getattr(jpc, fn)(*args)))
    got = emulate_wgmma(torch.from_numpy(x), cb).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_emulated_chain_matches_twin_chain(small_net):
    """The small geometry's whole forward, every stage through the
    emulated kernel, against the same chain on the twin, within 1e-4 *
    max|ref| in float32 (the card's bar for a whole chain)."""
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (1, 60, 24, 2)).astype(np.float32))
    want = fused_forward(small_net, x, True)
    real = fl.banded_conv
    fl.banded_conv = emulate_wgmma
    try:
        got = fused_forward(small_net, x, True)
    finally:
        fl.banded_conv = real
    assert (got - want).abs().max() <= 1e-4 * want.abs().max()


def test_ragged_t_pads_to_the_unpadded_result():
    """A ragged T: ``tma_frames`` hands the kernel x padded with zero
    frames to a multiple of 8, and the stage on it equals the stage on the
    unpadded x, bit for bit in the emulation and within the card's bar of
    the twin on the unpadded x."""
    cb = _flagship_stages()["3x3-d3"]
    rng = np.random.default_rng(9)
    x = _rand(rng, 1, cb.r_in, 37).to(torch.bfloat16)
    plan = fl.band_tma_plan(cb, 37)
    assert plan.t_pad == 40
    xp = fl.tma_frames(x, plan.t_pad)
    assert xp.shape[-1] == 40 and not xp[..., 37:].any()
    assert torch.equal(xp[..., :37], x)
    assert fl.tma_frames(xp, 40) is xp
    got = emulate_wgmma(x, cb, True)
    assert torch.equal(got, emulate_wgmma(xp, cb, True)[..., :37])
    _close(got, fl.banded_conv_reference(x, cb, True), 1e-2, "ragged")


def test_plan_covers_every_tap_and_band(small_net):
    """Every stage of the flagship and the small forward: each tap's box
    offset is a whole 8 frames and offset + shift is its dt with 0 <=
    shift < 8, so a box's frames never pass the tile by more than the edge
    box; the chunks cover each band; T pads to a multiple of 8."""
    nets = [small_net, TimbreTrapNet(540, 128, 2)]
    for net in nets:
        for cb in forward_spec(net, True).convs():
            for t in (1024, 1001, 37):
                plan = fl.band_tma_plan(cb, t)
                assert plan.t_pad % fl.TMA_FRAME_ALIGN == 0
                assert 0 <= plan.t_pad - t < fl.TMA_FRAME_ALIGN
                assert plan.tiles * fl.WGMMA_TILE_T >= t
                assert plan.n_sub == cb.n_sub
                for (off, shift), dt in zip(plan.taps, cb.dts):
                    assert off % fl.TMA_FRAME_ALIGN == 0
                    assert 0 <= shift < fl.WGMMA_EDGE_T
                    assert off + shift == dt
                for (start, length, chunks), band in zip(plan.bands,
                                                         cb.bands):
                    assert (start, length) == band
                    assert (chunks - 1) * fl.WGMMA_KC < length
                    assert length <= chunks * fl.WGMMA_KC


@pytest.mark.parametrize("t,tma", [(1024, 1), (3072, 1), (1001, 0),
                                   (37, 0)])
def test_plan_picks_the_epilogue_by_t(small_net, t, tma):
    """The plan's last integer picks the epilogue from T alone: the TMA
    epilogue (residual and y by tensor maps, whose rows must be a whole 16
    bytes) where T is a multiple of 8, as the chunks of 1024 frames and
    the recipe's 3072-frame crops are, for every stage alike; the staged
    one at a ragged T. It is the last integer the kernel reads."""
    for net in (small_net, TimbreTrapNet(540, 128, 2)):
        for cb in forward_spec(net, True).convs():
            assert fl.band_tma_plan(cb, t).tma_epilogue == tma
            t_pad, ints = fl._wgmma_plan(cb, t, cb.band_width)
            assert len(ints) == 20 and ints[19] == tma


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_banded_conv_takes_the_twin_on_cpu(monkeypatch, dtype):
    """On the CPU ``banded_conv`` hands its arguments to the twin and
    returns its result; neither launch path is reached, and under a
    profiler the call is one ``tt.k1`` span (a spy stands in for the
    twin)."""
    cb = _flagship_stages()["3x3-d3"]
    rng = np.random.default_rng(1)
    x = _rand(rng, 1, cb.r_in, 9).to(dtype)
    res = _rand(rng, 1, cb.r_out, 9).to(dtype)
    calls, sentinel = [], object()

    def spy(*a):
        calls.append(a)
        return sentinel

    def refuse(*a):
        raise AssertionError("a CPU tensor reached a kernel launch")

    monkeypatch.setattr(fl, "banded_conv_reference", spy)
    for launch in ("_launch_wgmma", "_launch_wgmma_f32"):
        monkeypatch.setattr(fl, launch, refuse)
    profiling.reset_record()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        assert fl.banded_conv(x, cb, True, res) is sentinel
    assert profiling.record()["tt.k1"]["count"] == 1
    assert len(calls) == 1
    assert all(g is w for g, w in zip(calls[0], (x, cb, True, res)))
