"""The chunk groups of ``TimbreTrap._chunked`` as CUDA graph replays.

On the CPU, at the small geometry (8 kHz, 5 octaves x 12 bins, 0.5-s
blocks, latent 16, complexity 1), with the capture stubbed where the CPU
has no CUDA graphs (the stub's replay runs the eager forward of its static
input):

* the Hann window is one tensor a model, equal to ``np.hanning(M)``, and
  no call builds it again;
* the graph keys: a 33-chunk piece gives groups of 4 and 1 chunks, the
  clip's length never enters a key, and a call of a shape seen before
  captures nothing;
* ``invalidate_specs`` and ``load_state_dict`` drop the graphs with the
  specs; a change of ``fused`` keeps both, and the float32 transcribe
  captures graphs of its own beside the bf16 ones;
* each replay adds the K1 launches its graph recorded to K1's counts;
* the spans: ``tt.graph.capture`` once a key and ``tt.graph.replay`` once a
  group inside ``tt.forward``, and the benchmark's readers of them;
* the CPU route's outputs are those of the overlap-add as it was written
  before the graphs (a window built per call, the chunks stacked).

On the card (``cuda`` marker, skipped without one), at the flagship
geometry: a replay is bit-equal to the eager group for the base model's
bf16 ``transcribe``, the float32 ``reconstruct``, the skip route and a
partial last group; after ``load_state_dict`` the output is the new
weights'; repeated calls of equal shape capture nothing new; K1's counts
follow the card: a warm call counts the eager groups' launches, a first
call those and one eager warm-up a graph, the capture none.
"""

import numpy as np
import pytest
import torch

from portbench import spec as bench_spec
from portbench import spans as bench_spans
from timbre_trap_tpu_torch.models import TimbreTrap
from timbre_trap_tpu_torch.models import timbre_trap
from timbre_trap_tpu_torch.ops.fused_level import banded_conv
from timbre_trap_tpu_torch.utils.profiling import record, reset_record

torch.set_num_threads(2)

HP = dict(sample_rate=8000, n_octaves=5, bins_per_octave=12,
          secs_per_block=0.5, latent_size=16, model_complexity=1)
FLAGSHIP = dict(sample_rate=22050, n_octaves=9, bins_per_octave=60,
                secs_per_block=3, latent_size=128, model_complexity=2)


def _clip(seconds, sample_rate=8000, seed=0, batch=1):
    rng = np.random.default_rng(seed)
    return (0.3 * rng.standard_normal((batch, 1, int(seconds * sample_rate)))
            ).astype(np.float32)


class _StubGraph:
    """A CUDA graph's stand-in on the CPU: ``replay`` runs the eager
    forward of the static input into the static output."""

    def __init__(self, run):
        self.run = run
        self.replays = 0

    def replay(self):
        self.replays += 1
        self.run()


# K1's launch counts: all, bf16, float32, float32 with the TMA epilogue.
K1_COUNTS = ("launches", "mma_launches", "mma_launches_f32",
             "tma_epilogue_launches_f32")

# The K1 launch counts the stub's graphs record for a
# replay, as the card's would for a forward of 60 conv stages.
STUB_LAUNCHES = {True: (60, 60, 0, 0), False: (60, 0, 60, 60)}


@pytest.fixture
def stubbed(monkeypatch):
    """Graph replays on the CPU: the route taken as on the card, the
    capture stubbed; yields the list of (transcribe, rows) captured."""
    captured = []

    def capture(self, transcribe, rows):
        captured.append((transcribe, rows))
        spec = self._spec(transcribe)
        static_in = torch.zeros((rows, 1, self.sliCQ.block_length))
        static_out = self._infer(static_in, transcribe).clone()
        graph = _StubGraph(lambda: static_out.copy_(
            self._infer(static_in, transcribe)))
        return timbre_trap._GroupGraph(graph, static_in, static_out, spec,
                                       STUB_LAUNCHES[transcribe])

    monkeypatch.setattr(timbre_trap, "_replays_graphs", lambda device: True)
    monkeypatch.setattr(TimbreTrap, "_capture", capture)
    return captured


def _piece_audio(m, seed=0):
    """One streamed piece as ``_chunked`` takes it: 16 blocks and a
    half-block halo on each side, 33 chunks."""
    L = m.sliCQ.block_length
    return torch.from_numpy(_clip((m.piece_blocks + 1) * L / 8000, seed=seed))


def _old_chunked(m, audio, transcribe):
    """``_chunked`` as the port wrote it before the graphs: the window
    built in the call, the chunks of each group stacked."""
    L, M = m.sliCQ.block_length, m.sliCQ.max_window_length
    F, B, C = m.sliCQ.n_bins, audio.shape[0], m.net.in_channels
    hop = L // 2
    n_chunks = (audio.shape[-1] - hop) // hop
    n_frames = m.sliCQ.get_expected_frames(audio.shape[-1])
    window = torch.as_tensor(np.hanning(M), dtype=torch.float32)
    acc = torch.zeros((B, C, F, n_frames + 2 * M), dtype=torch.float32)
    G = max(1, min(m.chunk_group, n_chunks))
    for g0 in range(0, n_chunks, G):
        n = min(G, n_chunks - g0)
        chunks = torch.stack([audio[..., (g0 + i) * hop:(g0 + i) * hop + L]
                              for i in range(n)])
        out = m._infer(chunks.reshape(n * B, 1, L), transcribe)
        out = out.reshape(n, B, C, F, M) * window
        for i in range(n):
            start = (g0 + i) * (M // 2)
            acc[..., start:start + M] += out[i]
    return acc[..., M // 2: n_frames - M // 2]


# --------------------------------------------------------------------- #
# The CPU                                                                #
# --------------------------------------------------------------------- #

def test_hann_window_is_one_resident_tensor(monkeypatch):
    m = TimbreTrap(**HP, seed=0, device="cpu")
    M = m.sliCQ.max_window_length
    window = m._window
    assert window.dtype == torch.float32 and window.device == m.device
    assert torch.equal(window, torch.as_tensor(np.hanning(M),
                                               dtype=torch.float32))

    def no_window(_):
        raise AssertionError("the window was built again")

    monkeypatch.setattr(timbre_trap.np, "hanning", no_window)
    for secs in (1.2, 3.1):
        m.transcribe(_clip(secs))
        m.reconstruct(_clip(secs))
    assert m._window is window
    assert m._window.data_ptr() == window.data_ptr()


@pytest.mark.parametrize("transcribe", [True, False])
def test_a_piece_captures_groups_of_four_and_one(stubbed, transcribe):
    m = TimbreTrap(**HP, seed=1, device="cpu")
    dtype = torch.bfloat16 if transcribe else torch.float32
    audio = _piece_audio(m)
    got = m._chunked(audio, transcribe)
    assert sorted(m._graphs) == [(transcribe, dtype, 1, 1),
                                 (transcribe, dtype, 4, 1)]
    assert stubbed == [(transcribe, 4), (transcribe, 1)]
    # 33 chunks: 8 groups of 4 replay one graph, the last chunk the other.
    assert m._graphs[(transcribe, dtype, 4, 1)].graph.replays == 8
    assert m._graphs[(transcribe, dtype, 1, 1)].graph.replays == 1
    assert torch.equal(got, _old_chunked(m, audio, transcribe))


@pytest.mark.parametrize("blocks", [4, 5, 9])
def test_the_clip_length_never_enters_a_key(stubbed, blocks):
    """Clips of other lengths whose chunk counts leave the same remainder
    replay the graphs already captured; a batch of two is a key of its
    own."""
    m = TimbreTrap(**HP, seed=2, device="cpu")
    L = m.sliCQ.block_length
    m.transcribe(_clip(blocks * L / 8000))
    keys = set(m._graphs)
    assert all(len(k) == 4 and k[:2] == (True, torch.bfloat16)
               and k[2] in (1, 2, 3, 4) and k[3] == 1 for k in keys)
    n_chunks = 2 * blocks + 1
    assert {k[2] for k in keys} == {4, n_chunks % 4} - {0}
    before = len(stubbed)
    # Four blocks more: eight chunks more, the same remainder.
    m.transcribe(_clip((blocks + 4) * L / 8000, seed=3))
    assert len(stubbed) == before and set(m._graphs) == keys
    m.transcribe(_clip(blocks * L / 8000, batch=2))
    assert {k[3] for k in m._graphs} == {1, 2}
    assert all(rows == k[2] * k[3] for (_, rows), k in
               zip(stubbed, m._graphs))


@pytest.mark.parametrize("drop", ["invalidate_specs", "load_state_dict",
                                  "fused"])
def test_graphs_are_dropped_with_the_specs(stubbed, drop):
    """The graphs go where the specs go. A change of ``fused`` keeps the
    specs, and the graphs with them: it changes only the compute dtype,
    which is in the key, so the float32 transcribe captures its own."""
    m = TimbreTrap(**HP, seed=4, device="cpu")
    other = TimbreTrap(**HP, seed=5, device="cpu")
    audio = _piece_audio(m)
    m._chunked(audio, True)
    m._chunked(audio, False)
    assert len(m._graphs) == 4 and m._specs
    if drop == "fused":
        kept = dict(m._graphs)
        m.fused = "f32"
        assert m._graphs == kept and m._specs
        got = m._chunked(audio, True)
        assert stubbed[-2:] == [(True, 4), (True, 1)]
        assert {k[:2] for k in m._graphs} == {
            (True, torch.bfloat16), (True, torch.float32),
            (False, torch.float32)}
        assert torch.equal(got, _old_chunked(m, audio, True))
        return
    if drop == "invalidate_specs":
        m.invalidate_specs()
    else:
        m.load_state_dict(other.net.state_dict())
    assert m._graphs == {} and not m._specs
    got = m._chunked(audio, True)
    assert len(m._graphs) == 2
    if drop == "load_state_dict":
        # The new graphs run the new weights.
        assert torch.equal(got, _old_chunked(other, audio, True))


@pytest.mark.parametrize("transcribe", [True, False])
def test_each_replay_adds_its_recorded_launches(stubbed, monkeypatch,
                                                transcribe):
    """K1's counts grow by the graph's recorded launches at every replay:
    nine groups of a 33-chunk piece, on the route of the branch's dtype."""
    m = TimbreTrap(**HP, seed=9, device="cpu")
    audio = _piece_audio(m)
    for name in K1_COUNTS:
        monkeypatch.setattr(banded_conv, name, 0)
    m._chunked(audio, transcribe)
    m._chunked(audio, transcribe)
    got = [getattr(banded_conv, name) for name in K1_COUNTS]
    assert got == [2 * 9 * k for k in STUB_LAUNCHES[transcribe]]


def test_graph_spans_and_their_readers(stubbed):
    """Under a profiler, one ``tt.graph.capture`` a key and one
    ``tt.graph.replay`` a group, each inside its ``tt.forward``; the
    benchmark's readers turn them into the host's microseconds a replay
    and the share of groups no earlier capture served, and give None on a
    record without replays."""
    m = TimbreTrap(**HP, seed=6, device="cpu")
    audio = _piece_audio(m)
    reset_record()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        m._chunked(audio, True)
        first = record()
        reset_record()
        m._chunked(audio, True)
        again = record()
    assert first["tt.graph.capture"]["count"] == 2
    assert first["tt.graph.replay"]["count"] == first["tt.forward"]["count"]
    assert first["tt.graph.replay"]["items"] == 33
    assert "tt.graph.capture" not in again
    assert again["tt.graph.replay"]["items"] == 33
    for rec in (first, again):
        fwd = rec["tt.forward"]
        assert fwd["total_s"] > rec["tt.graph.replay"]["total_s"]

    def read(rec, name, kind):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(bench_spans, "record", lambda: rec)
            return bench_spec.metric_reader(f"{name}.{kind}")({})

    for kind in ("transcribe", "reconstruct"):
        assert read(first, "graph_miss_pct", kind) == pytest.approx(
            100.0 * 2 / 9)
        assert read(again, "graph_miss_pct", kind) == 0.0
        us = read(again, "graph_host_us_per_replay", kind)
        assert us == pytest.approx(1e6 * again["tt.graph.replay"]["total_s"]
                                   / 9)
        no_graphs = {"tt.forward": again["tt.forward"]}
        assert read(no_graphs, "graph_miss_pct", kind) is None
        assert read(no_graphs, "graph_host_us_per_replay", kind) is None


@pytest.mark.parametrize("skips", [False, True])
@pytest.mark.parametrize("transcribe", [True, False])
def test_cpu_route_outputs_are_unchanged(skips, transcribe):
    m = TimbreTrap(**HP, skip_connections=skips, seed=7, device="cpu")
    audio = m._pad_for_chunks(torch.from_numpy(_clip(2.3, seed=8)))
    got = m._chunked(audio, transcribe)
    assert m._graphs == {}
    assert torch.equal(got, _old_chunked(m, audio, transcribe))


# --------------------------------------------------------------------- #
# The card                                                               #
# --------------------------------------------------------------------- #

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device for CUDA graphs and the "
                    "hand-written kernels")
    return torch.device("cuda")


def _eager(monkeypatch, fn):
    """``fn()`` with every chunk group run eagerly on the card."""
    with monkeypatch.context() as mp:
        mp.setattr(timbre_trap, "_replays_graphs", lambda device: False)
        return fn()


def _flagship_clip(blocks, seed, batch=1):
    return _clip(blocks * FLAGSHIP["secs_per_block"] - 0.7, 22050, seed,
                 batch)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["transcribe", "reconstruct",
                                  "skips-transcribe", "skips-reconstruct",
                                  "partial-batch"])
def test_replay_is_bit_equal_to_the_eager_group(cuda_device, monkeypatch,
                                                case):
    """At the cells' shapes: a streamed 40-block clip (pieces of 33
    chunks: groups of 4 and a last group of 1) and a 10-block clip (21
    chunks, the last group partial) in one pass; a batch of two of 7
    blocks (15 chunks, a last group of 3)."""
    m = TimbreTrap(**FLAGSHIP, skip_connections=case.startswith("skips"),
                   seed=11, device=cuda_device)
    run = m.reconstruct if case.endswith("reconstruct") else m.transcribe
    clips = ([_flagship_clip(7, 13, batch=2)] if case == "partial-batch"
             else [_flagship_clip(40, 12), _flagship_clip(10, 14)])
    for clip in clips:
        got = run(clip)
        want = _eager(monkeypatch, lambda: run(clip))
        assert m._graphs
        assert got.shape == want.shape
        assert torch.equal(got, want), (case, clip.shape,
                                        (got - want).abs().max().item())
    sizes = {k[2] for k in m._graphs}
    assert sizes == ({4, 3} if case == "partial-batch" else {4, 1})


@pytest.mark.cuda
def test_after_load_state_dict_the_graphs_run_the_new_weights(cuda_device,
                                                              monkeypatch):
    m = TimbreTrap(**FLAGSHIP, seed=21, device=cuda_device)
    new = TimbreTrap(**FLAGSHIP, seed=22, device=cuda_device)
    clip = _flagship_clip(40, 23)
    before = m.transcribe(clip)
    m.load_state_dict(new.net.state_dict())
    assert m._graphs == {}
    got = m.transcribe(clip)
    assert not torch.equal(got, before)
    assert torch.equal(got, new.transcribe(clip))
    assert torch.equal(got, _eager(monkeypatch, lambda: new.transcribe(clip)))


@pytest.mark.cuda
def test_calls_of_equal_shape_capture_nothing_new(cuda_device, monkeypatch):
    m = TimbreTrap(**FLAGSHIP, seed=31, device=cuda_device)
    captures = []
    capture = TimbreTrap._capture

    def counted(self, transcribe, rows):
        captures.append((transcribe, rows))
        return capture(self, transcribe, rows)

    monkeypatch.setattr(TimbreTrap, "_capture", counted)
    m.transcribe(_flagship_clip(40, 32))
    m.reconstruct(_flagship_clip(40, 32))
    assert sorted(captures) == [(False, 1), (False, 4), (True, 1), (True, 4)]
    graphs = dict(m._graphs)
    for seed in (33, 34):
        m.transcribe(_flagship_clip(48, seed))
        m.reconstruct(_flagship_clip(36, seed))
    assert len(captures) == 4
    assert all(m._graphs[k] is g for k, g in graphs.items())


def _k1_counts(fn):
    """K1's launch counts (``K1_COUNTS``) over ``fn()``."""
    before = [getattr(banded_conv, name) for name in K1_COUNTS]
    fn()
    torch.cuda.synchronize()
    return [getattr(banded_conv, name) - b
            for name, b in zip(K1_COUNTS, before)]


@pytest.mark.cuda
@pytest.mark.parametrize("transcribe", [True, False])
def test_k1_counts_follow_the_card(cuda_device, monkeypatch, transcribe):
    """A warm call counts the launches of its replays, as many as the eager
    groups launch; a first call those and one eager warm-up a graph; the
    capture none. Every launch on the branch's dtype route, every float32
    one with the TMA epilogue (chunks of 1024 frames)."""
    m = TimbreTrap(**FLAGSHIP, seed=41, device=cuda_device)
    run = m.transcribe if transcribe else m.reconstruct
    clip = _flagship_clip(40, 42)
    per_forward = sum(1 for _ in m._spec(transcribe).convs())
    first = _k1_counts(lambda: run(clip))
    warm = _k1_counts(lambda: run(clip))
    eager = _k1_counts(lambda: _eager(monkeypatch, lambda: run(clip)))
    assert warm == eager and eager[0] > 0
    assert eager[0] % per_forward == 0
    assert len(m._graphs) == 2
    assert first[0] == eager[0] + per_forward * len(m._graphs)
    route = 1 if transcribe else 2
    assert first[route] == first[0] and first[3 - route] == 0
    assert first[3] == first[2] and warm[3] == warm[2]
