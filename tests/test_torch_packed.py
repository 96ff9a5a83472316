"""The port's packed conv formulation, conv chain (K1) and peak mask (K2)
against the JAX package.

On the CPU every kernel wrapper takes its plain PyTorch twin, so these
tests hold the twins (and the block builders, the spec layer and the
weight layout) against the JAX functions at small sizes. The kernels
themselves are held against the twins on the card by
``tests/test_torch_kernels.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from timbre_trap_tpu.interop import export_torch_state_dict
from timbre_trap_tpu.models.fused import fused_forward as jax_fused_forward
from timbre_trap_tpu.models.modules import DecoderBlock as JaxDecoderBlock
from timbre_trap_tpu.models.modules import EncoderBlock as JaxEncoderBlock
from timbre_trap_tpu.models.modules import TimbreTrapNet as JaxNet
from timbre_trap_tpu.ops import packed_conv as jpc
from timbre_trap_tpu.ops.fused_level import (
    decoder_level_spec as jax_decoder_level_spec,
    encoder_level_spec as jax_encoder_level_spec, packed_level_apply_xla)
from timbre_trap_tpu.ops.peaks import _peak_mask_xla
from timbre_trap_tpu.utils.processing import filter_non_peaks, threshold
from timbre_trap_tpu_torch.interop import state_dict_from_jax
from timbre_trap_tpu_torch.models import TimbreTrapNet, fused_forward
from timbre_trap_tpu_torch.ops import packed_conv as pc
from timbre_trap_tpu_torch.ops.fused_level import (
    HALO, LevelSpec, decoder_level_spec, encoder_level_spec, fuse_level_specs,
    fused_level_apply, packed_level_apply)
from timbre_trap_tpu_torch.ops.peaks import peak_mask

torch.set_num_threads(2)


def _np_tree(params):
    return jax.tree.map(np.asarray, params)


def _torch_tree(params):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), params)


def _rand(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


# --------------------------------------------------------------------- #
# Block builders                                                         #
# --------------------------------------------------------------------- #

def _builder_cases():
    rng = np.random.default_rng(11)
    cases = {}
    for c, f in [(4, 540), (32, 65)]:
        for d in (1, 2, 3):
            cases[f"conv3x3-c{c}-d{d}"] = (
                "build_conv2d_blocks",
                (_rand(rng, 3, 3, c, c), _rand(rng, c), f, d), {})
        cases[f"conv1x1-c{c}"] = ("build_conv2d_blocks",
                                  (_rand(rng, 1, 1, c, c), _rand(rng, c), f), {})
        cases[f"sconv-c{c}"] = ("build_sconv_blocks",
                                (_rand(rng, 4, 1, c, 2 * c), _rand(rng, 2 * c),
                                 f), {"stride": 2})
    cases["convin-2-4"] = ("build_conv2d_blocks",
                           (_rand(rng, 3, 3, 2, 4), _rand(rng, 4), 540), {})
    cases["convout-4-2"] = ("build_conv2d_blocks",
                            (_rand(rng, 3, 3, 4, 2), _rand(rng, 2), 540), {})
    for c, f, p in [(64, 31, 0), (8, 269, 1)]:
        cases[f"tconv-c{c}-p{p}"] = (
            "build_tconv_blocks", (_rand(rng, 4, 1, c, c // 2),
                                   _rand(rng, c // 2), f),
            {"stride": 2, "output_padding": p})
    for r_out, r_in in [(128, 1984), (1984, 128), (270, 129)]:
        cases[f"dense-{r_out}x{r_in}"] = (
            "build_dense_blocks", (_rand(rng, r_out, r_in), _rand(rng, r_out)),
            {})
    return cases


_CASES = _builder_cases()


@pytest.mark.parametrize("name", sorted(_CASES))
def test_builders_equal_jax(name):
    fn, args, kwargs = _CASES[name]
    want = getattr(jpc, fn)(*args, **kwargs)
    got = getattr(pc, fn)(*[torch.from_numpy(a) if isinstance(a, np.ndarray)
                            else a for a in args], **kwargs)
    assert (got.dts, got.col_adv, got.margin, got.k, got.per_block,
            got.r_in, got.r_out) == \
        (want.dts, want.col_adv, want.margin, want.k,
         getattr(want, "per_block", False), want.r_in, want.r_out)
    np.testing.assert_array_equal(got.blocks.numpy(), np.asarray(want.blocks))
    np.testing.assert_array_equal(got.bias.numpy(), np.asarray(want.bias))


def test_pack_round_trip():
    x = torch.from_numpy(_rand(np.random.default_rng(0), 2, 13, 9, 4))
    assert torch.equal(pc.unpack_to_nhwc(pc.pack_nhwc(x), 4), x)
    y = x.permute(0, 3, 1, 2)
    assert torch.equal(pc.unpack_to_nchw(pc.pack_nchw(y), 4), y)
    assert torch.equal(pc.pack_nchw(y), pc.pack_nhwc(x))


# --------------------------------------------------------------------- #
# Level chains (the plain twin of K1)                                    #
# --------------------------------------------------------------------- #

def _numpy_params(mod, x, rng):
    """Parameters with the flax module's tree and shapes (``eval_shape``:
    nothing is compiled or run), drawn with numpy: kernels at the LeCun
    scale of flax's init, biases at 0.1. The values then depend on the seed
    alone, not on executables that other test processes leave in the
    persistent compilation cache (``tests/conftest.py``)."""
    shapes = jax.eval_shape(lambda: mod.init(jax.random.PRNGKey(1), x))

    def draw(path, leaf):
        if path[-1].key == "kernel":
            fan_in = int(np.prod(leaf.shape[:-1]))
            return jnp.asarray(_rand(rng, *leaf.shape, scale=fan_in ** -0.5))
        return jnp.asarray(_rand(rng, *leaf.shape, scale=0.1))

    return jax.tree_util.tree_map_with_path(draw, shapes["params"])


@pytest.mark.parametrize("kind,c,f", [("encoder", 4, 540), ("decoder", 64, 31)])
def test_packed_level_apply_matches_xla(kind, c, f):
    rng = np.random.default_rng(c)
    B, T = 2, 40
    x = jnp.asarray(_rand(rng, B, f, T, c))
    if kind == "encoder":
        mod = JaxEncoderBlock(out_channels=2 * c)
        params = _numpy_params(mod, x, rng)
        want_spec = jax_encoder_level_spec(params, f)
        spec = encoder_level_spec(_torch_tree(params), f)
    else:
        mod = JaxDecoderBlock(out_channels=c // 2, padding=0)
        params = _numpy_params(mod, x, rng)
        want_spec = jax_decoder_level_spec(params, f, output_padding=0)
        spec = decoder_level_spec(_torch_tree(params), f, output_padding=0)
    xp = jpc.pack_nhwc(x)
    want = np.asarray(packed_level_apply_xla(xp, want_spec))
    xt = torch.from_numpy(np.array(xp))
    for got in (packed_level_apply(xt, spec), fused_level_apply(xt, spec)):
        np.testing.assert_allclose(got.numpy(), want, atol=5e-5, rtol=1e-4)


def test_fuse_level_specs_raises_past_the_halo():
    rng = np.random.default_rng(0)
    cb = pc.build_conv2d_blocks(torch.from_numpy(_rand(rng, 3, 3, 4, 4)),
                                torch.zeros(4), 32, dilation=3)
    spec = LevelSpec([("conv", cb, True)], cb.r_in)
    assert len(fuse_level_specs([spec] * (HALO // 3)).items) == HALO // 3
    with pytest.raises(ValueError, match="halo"):
        fuse_level_specs([spec] * (HALO // 3 + 1))


@pytest.fixture(scope="module")
def small_net():
    """JAX TimbreTrapNet (F=60, latent 16, complexity 1) and the port's
    net with the same weights."""
    rng = np.random.default_rng(3)
    net = JaxNet(feature_size=60, latent_size=16, model_complexity=1)
    x = _rand(rng, 1, 60, 24, 2)
    params = net.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    port = TimbreTrapNet(60, 16, 1)
    port.load_state_dict(state_dict_from_jax(_np_tree(params)), strict=True)
    return net, params, port, x


def test_state_dict_from_jax_equals_export(small_net):
    _, params, port, _ = small_net
    want = export_torch_state_dict(_np_tree(params),
                                   like=port.state_dict().keys())
    got = state_dict_from_jax(_np_tree(params))
    assert set(got) == set(want) == set(port.state_dict())
    for key, value in want.items():
        np.testing.assert_array_equal(got[key].numpy(), value, err_msg=key)


def test_fused_forward_matches_jax_interpret(small_net):
    """The whole forward as one chain, f32, vs the JAX single-kernel chain
    run in Pallas interpret mode."""
    net, params, port, x = small_net
    want = np.asarray(jax_fused_forward(params, net, jnp.asarray(x), True,
                                        interpret=True))
    got = fused_forward(port, torch.from_numpy(x), True).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-3)


@pytest.mark.parametrize("transcribe", [True, False])
def test_fused_forward_matches_module_and_bf16(small_net, transcribe):
    """The packed chain equals the port's NCHW module forward in f32, and
    the bf16 chain (bf16 storage, f32 accumulation) stays within 5e-2."""
    _, _, port, x = small_net
    xt = torch.from_numpy(x)
    ref = port(xt.permute(0, 3, 1, 2), transcribe).detach()
    got = fused_forward(port, xt, transcribe)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-4, rtol=1e-3)
    got16 = fused_forward(port, xt, transcribe, dtype=torch.bfloat16)
    np.testing.assert_allclose(got16.numpy(), ref.numpy(), atol=5e-2,
                               rtol=5e-2)


# --------------------------------------------------------------------- #
# Peak mask (the plain twin of K2)                                       #
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("t", [0.5, 0.0, -0.25])
def test_peak_mask_matches_xla(t):
    a = np.random.default_rng(4).uniform(size=(2, 60, 300)).astype(np.float32)
    a[0, 10:13, :5] = 0.7  # a plateau is no peak
    want = np.asarray(_peak_mask_xla(jnp.asarray(a), t))
    np.testing.assert_array_equal(
        want, threshold(filter_non_peaks(a), t).astype(np.uint8))
    got = peak_mask(torch.from_numpy(a), t)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
