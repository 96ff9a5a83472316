"""The port's spans (``timbre_trap_tpu_torch.utils.profiling.span``) and
their record, on the CPU at the small geometry (8 kHz, 5 octaves x 12
bins, 0.5-s blocks, latent 16, complexity 1):

* with no profiler running a span is one shared no-op: a transcribe
  records nothing and leaves no ``tt.*`` event behind;
* under a CPU ``torch.profiler`` a span is a Kineto CPU op, not a user
  annotation, nested in time inside the ``record_function`` around it;
* the record's count, items, total and self times on a toy nesting, self
  time per thread (a span on another thread is no child), and no update
  lost when more threads than cores add to it at once;
* ``kernel_counts``' names: the base function name of each kind of
  demangled kernel signature the profiler records; on the CPU its block
  runs and counts nothing;
* a streamed transcribe and reconstruct record the ``_chunked``
  arithmetic (33 chunks a 16-block piece, 9 forwards) and one ``tt.k1``
  span a conv stage of each forward, base and skip route, and build the
  inference chain on the first call only;
* a ``pallas_bf16`` step on the CPU twin records each ``tt.step.*`` span
  once a step and refreshes its level specs once a step;
* the kept specs: the geometry is built once (one ``tt.prepare``, none
  on later steps), the band operands stay at the same addresses, two nets
  of different geometry keep entries of their own, and ``transcribe``
  after a step runs the stepped weights.
"""

import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

from timbre_trap_tpu_torch.models import TimbreTrap, fused
from timbre_trap_tpu_torch.train import (TrainConfig, init_train_state,
                                         make_train_step, synthetic_batch)
from timbre_trap_tpu_torch.utils import profiling
from timbre_trap_tpu_torch.utils.profiling import record, reset_record, span

torch.set_num_threads(2)

HP = dict(sample_rate=8000, n_octaves=5, bins_per_octave=12,
          secs_per_block=0.5, latent_size=16, model_complexity=1)
CPU_ACTS = [torch.profiler.ProfilerActivity.CPU]


def _profiled(fn):
    """``fn()`` under a CPU profiler, the record cleared first; returns
    (the record, the profile)."""
    reset_record()
    with torch.profiler.profile(activities=CPU_ACTS) as prof:
        fn()
    return record(), prof


def _events(prof):
    return list(prof.profiler.kineto_results.events())


def _clip(seconds, seed=0):
    rng = np.random.default_rng(seed)
    return (0.3 * rng.standard_normal((1, 1, int(seconds * 8000)))
            ).astype(np.float32)


def _stages(spec):
    """K1 stages of one forward of ``forward_spec``'s result."""
    specs = (spec.especs + spec.dspecs) if hasattr(spec, "especs") \
        else [spec]
    return sum(1 for s in specs for _ in s.convs())


def test_off_path_records_nothing_and_emits_no_event():
    m = TimbreTrap(**HP, seed=1, device="cpu")
    assert not torch.autograd._profiler_enabled()
    assert span("tt.a") is span("tt.b", 4)
    assert profiling.annotate is span
    reset_record()
    m.transcribe(_clip(1.0))
    assert record() == {}
    rec, prof = _profiled(lambda: torch.ones(4).sum())
    assert rec == {}
    assert not [e for e in _events(prof) if e.name().startswith("tt.")]


def test_spans_are_cpu_ops_nested_in_their_parent():
    def fn():
        with torch.profiler.record_function("parent"):
            with span("tt.outer"):
                with span("tt.inner"):
                    torch.ones(8, 8).sum()

    rec, prof = _profiled(fn)
    ev = {e.name(): e for e in _events(prof)}
    parent = ev["parent"]
    assert parent.is_user_annotation()
    for name in ("tt.outer", "tt.inner"):
        e = ev[name]
        assert not e.is_user_annotation()
        assert e.device_type() == torch.autograd.DeviceType.CPU
        assert parent.start_ns() <= e.start_ns()
        assert (e.start_ns() + e.duration_ns()
                <= parent.start_ns() + parent.duration_ns())
    outer, inner = ev["tt.outer"], ev["tt.inner"]
    assert outer.start_ns() <= inner.start_ns()
    assert set(rec) == {"tt.outer", "tt.inner"}


def test_record_counts_items_and_self_time():
    def fn():
        for _ in range(3):
            with span("tt.outer"):
                time.sleep(0.002)
                for k in (2, 5):
                    with span("tt.inner", k):
                        time.sleep(0.003)

    rec, _ = _profiled(fn)
    outer, inner = rec["tt.outer"], rec["tt.inner"]
    assert (outer["count"], outer["items"]) == (3, 3)
    assert (inner["count"], inner["items"]) == (6, 21)
    assert inner["self_s"] == inner["total_s"] >= 6 * 0.003
    assert outer["self_s"] == pytest.approx(
        outer["total_s"] - inner["total_s"], abs=1e-9)
    assert outer["self_s"] >= 3 * 0.002
    # Timer's own view of the record keeps its keys.
    assert set(profiling._RECORD.summary()["tt.outer"]) == {
        "total_s", "count", "mean_ms"}
    reset_record()
    assert record() == {}


def test_self_time_is_per_thread():
    """A span on another thread (the autograd engine's, on the card) is
    no child of the span open on this one; its own stack starts empty."""
    def other():
        with profiling._Span("tt.other", 1):
            time.sleep(0.03)

    def fn():
        with span("tt.main"):
            t = threading.Thread(target=other)
            t.start()
            t.join(timeout=30)
            assert not t.is_alive()

    rec, _ = _profiled(fn)
    main, other_rec = rec["tt.main"], rec["tt.other"]
    assert other_rec["count"] == 1 and other_rec["total_s"] >= 0.03
    assert main["self_s"] == main["total_s"] >= other_rec["total_s"]


def test_many_threads_lose_no_update():
    """More threads than cores nest spans at once, the interpreter
    switching threads every microsecond: every span is counted, and each
    thread's inner time comes off its own outer span only."""
    n_threads = (os.cpu_count() or 2) + 4
    n_iter = 200
    old = sys.getswitchinterval()

    def work():
        for _ in range(n_iter):
            with profiling._Span("tt.outer", 1):
                with profiling._Span("tt.inner", 2):
                    pass

    reset_record()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    rec = record()
    n = n_threads * n_iter
    assert (rec["tt.outer"]["count"], rec["tt.inner"]["count"]) == (n, n)
    assert rec["tt.inner"]["items"] == 2 * n
    assert rec["tt.outer"]["self_s"] == pytest.approx(
        rec["tt.outer"]["total_s"] - rec["tt.inner"]["total_s"], abs=1e-6)
    reset_record()


@pytest.mark.parametrize("recorded,name", [
    ("(anonymous namespace)::band_wgmma_kernel(CUtensorMap_st, "
     "CUtensorMap_st, int, int)", "band_wgmma_kernel"),
    ("void (anonymous namespace)::elu_backward_kernel<__nv_bfloat16>("
     "__nv_bfloat16 const*, __nv_bfloat16 const*, __nv_bfloat16 const*, "
     "float*, float*, long long)", "elu_backward_kernel"),
    ("void (anonymous namespace)::band_product_kernel<__nv_bfloat16, true>("
     "(anonymous namespace)::BandArgs)", "band_product_kernel"),
    ("void (anonymous namespace)::band_tf32_kernel<true>("
     "(anonymous namespace)::BandArgs)", "band_tf32_kernel"),
    ("(anonymous namespace)::band_dw_reduce_kernel(float const*, float "
     "const*, float*, float*, int, int, int, int, int, int, int)",
     "band_dw_reduce_kernel"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::"
     "FillFunctor<float>, std::array<char*, 1ul> >(int, at::native::"
     "FillFunctor<float>, std::array<char*, 1ul>)",
     "vectorized_elementwise_kernel"),
    ("peak_mask_kernel", "peak_mask_kernel"),
])
def test_kernel_name_is_the_base_function_name(recorded, name):
    assert profiling.kernel_name(recorded) == name


def test_kernel_counts_on_the_cpu_count_nothing():
    """The block runs under the profiler (the spans record), and a machine
    without a card runs no device kernel: the counter stays empty."""
    reset_record()
    with profiling.kernel_counts() as counts:
        with span("tt.a"):
            torch.ones(8, 8).sum()
        assert counts == {}
    assert counts == {} and record()["tt.a"]["count"] == 1


@pytest.mark.parametrize("skips", [False, True])
def test_streamed_transcribe_records_the_chunked_arithmetic(skips):
    m = TimbreTrap(**HP, skip_connections=skips, seed=2, device="cpu")
    rec, _ = _profiled(lambda: m.transcribe(_clip(0.5)))
    assert rec["tt.spec_build"]["count"] == 1     # the first call builds it
    assert rec["tt.forward"]["items"] == 3        # one block: 2 + 1 chunks
    # 32 blocks: 2 pieces of 16 blocks, each 33 chunks in 9 forwards.
    audio = _clip(32 * 0.5 - 0.1)
    rec, _ = _profiled(lambda: m.transcribe(audio))
    pieces, forwards = 2, 9 * 2
    assert rec["tt.transcribe"]["count"] == 1
    assert rec["tt.forward"]["items"] == 33 * pieces
    assert rec["tt.forward"]["count"] == forwards
    assert rec["tt.analysis"]["count"] == forwards
    assert rec["tt.pack"]["count"] == rec["tt.unpack"]["count"] == forwards
    # Each piece's accumulator, then each chunk group's add.
    assert rec["tt.overlap_add"]["count"] == pieces + forwards
    assert rec["tt.activations"]["count"] == pieces
    assert rec["tt.concat"]["count"] == 1
    assert "tt.spec_build" not in rec              # nor the second
    assert rec["tt.k1"]["count"] == _stages(m._spec(True)) * forwards
    assert rec["tt.chain"]["count"] == forwards * (10 if skips else 1)
    if skips:
        assert rec["tt.skip.bridge"]["count"] == forwards
        assert rec["tt.skip.add"]["count"] == 5 * forwards
    else:
        assert not any(k.startswith("tt.skip.") for k in rec)
    top = rec["tt.transcribe"]
    assert 0 < top["self_s"] < top["total_s"]


def test_streamed_reconstruct_records_its_spans():
    m = TimbreTrap(**HP, seed=3, device="cpu")
    audio = _clip(32 * 0.5)
    m.reconstruct(audio[..., :4000])   # builds the float32 spec
    rec, _ = _profiled(lambda: m.reconstruct(audio))
    assert rec["tt.reconstruct"]["count"] == 1
    assert rec["tt.forward"]["items"] == 33 * 2
    assert rec["tt.synthesis"]["count"] == 2
    assert rec["tt.normalize"]["count"] == 1
    assert rec["tt.concat"]["count"] == 1
    assert rec["tt.k1"]["count"] == _stages(m._spec(False)) * 9 * 2
    assert "tt.spec_build" not in rec


def test_bf16_step_records_each_part_once_a_step():
    m = TimbreTrap(**HP, seed=4, device="cpu")
    cfg = TrainConfig()
    state = init_train_state(m, cfg)
    step = make_train_step(m, cfg, 1, conv_backend="pallas_bf16",
                           compact_audio_grid=True)
    audio, gt = synthetic_batch(m, 2, 0.5, seed=5)
    gt = gt[:1]
    n_steps = 2

    def run():
        for _ in range(n_steps):
            float(step(state, audio, gt, 1e-3)["loss/total"])

    rec, _ = _profiled(run)
    for part in ("upload", "forward", "backward", "update"):
        assert rec[f"tt.step.{part}"]["count"] == n_steps, part
    assert "tt.step.reduce" not in rec
    assert rec["tt.spec_build"]["count"] == n_steps
    assert rec["tt.analysis"]["count"] == n_steps
    step_s = sum(rec[f"tt.step.{p}"]["total_s"]
                 for p in ("upload", "forward", "backward", "update"))
    assert rec["tt.spec_build"]["total_s"] < step_s


def _kept_train_specs(net):
    """The net's kept training specs as the last refresh left them."""
    (specs,) = [v for k, v in fused._KEPT[net].items() if k[0]]
    return specs


def _recipe_step(m, seed):
    cfg = TrainConfig()
    state = init_train_state(m, cfg)
    step = make_train_step(m, cfg, 1, conv_backend="pallas_bf16",
                           compact_audio_grid=True)
    audio, gt = synthetic_batch(m, 1, 0.25, seed=seed)
    return lambda: float(step(state, audio, gt, 1e-3)["loss/total"])


def _operand_pointers(especs, dspecs):
    return [t.data_ptr() for spec in especs + dspecs for cb in spec.convs()
            for t in (*cb.band_operands(torch.bfloat16),
                      cb.adjoint.band_operands(torch.bfloat16)[0],
                      cb.band_operands(torch.float32)[0],
                      cb.band_tf32_operands()[0])]


def test_kept_specs_build_once_and_stay_put():
    m = TimbreTrap(**HP, seed=8, device="cpu")
    run = _recipe_step(m, 9)
    rec, _ = _profiled(run)
    assert rec["tt.prepare"]["count"] == 1        # the geometry, once
    assert rec["tt.spec_build"]["count"] == 1
    specs = _kept_train_specs(m.net)
    pointers = _operand_pointers(*specs)
    before = specs[0][0].store.f.clone()
    n_steps = 3
    rec, _ = _profiled(lambda: [run() for _ in range(n_steps)])
    assert "tt.prepare" not in rec
    assert rec["tt.spec_build"]["count"] == n_steps
    again = _kept_train_specs(m.net)
    assert all(a is b for a, b in zip(again[0] + again[1],
                                      specs[0] + specs[1]))
    assert _operand_pointers(*again) == pointers
    assert not torch.equal(again[0][0].store.f, before)   # refreshed


def test_nets_of_other_geometry_keep_their_own_specs():
    a = TimbreTrap(**HP, seed=10, device="cpu")
    b = TimbreTrap(**dict(HP, n_octaves=4), seed=10, device="cpu")
    steps = [_recipe_step(m, 11) for m in (a, b)]
    for run in steps:
        run()
    store_a, store_b = (_kept_train_specs(m.net)[0][0].store for m in (a, b))
    assert store_a is not store_b
    f_ins = [[cb.f_in for cb in store.specs[0].convs()]
             for store in (store_a, store_b)]
    assert f_ins[0] != f_ins[1]
    assert fused._KEPT[a.net].keys().isdisjoint(fused._KEPT[b.net].keys())
    f_a = store_a.f.clone()
    steps[1]()
    assert torch.equal(store_a.f, f_a)          # b's refresh leaves a's


def test_transcribe_after_kept_step_runs_the_stepped_weights():
    m = TimbreTrap(**HP, seed=12, device="cpu")
    clip = _clip(1.0)
    before = m.transcribe(clip)
    _recipe_step(m, 13)()
    after = m.transcribe(clip)
    fresh = TimbreTrap(**HP, seed=0, device="cpu")
    fresh.net.load_state_dict(m.net.state_dict())
    assert not torch.equal(after, before)
    assert torch.equal(after, fresh.transcribe(clip))
