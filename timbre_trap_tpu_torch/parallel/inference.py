"""Long-form inference with the chunk axis split over the ranks (the
port's counterpart of ``timbre_trap_tpu/parallel/inference.py``).

Chunks of the 50%-overlap stream are independent except for the Hann
overlap-add, so each rank runs its own contiguous share of the chunks
through the model's chain (on the card: the conv chain kernel) and adds
them into a zero accumulator of the whole signal; one all-reduce (SUM)
over the mesh's group then combines the accumulators, and every rank
returns the same coefficients.
"""

import torch
import torch.distributed as dist

from .mesh import DATA_AXIS

__all__ = ["make_sharded_chunked_inference"]


def make_sharded_chunked_inference(model, mesh, transcribe=True):
    """Build ``run(audio (B, 1, N)) -> coefficients (B, C, F, T)``, the
    chunk axis split over the ranks of ``mesh``.

    ``run`` pads and frames the audio as ``TimbreTrap.chunked_inference``
    does; rank r of n runs chunks ``[r * K / n, (r + 1) * K / n)`` of the
    K chunks, ``model.chunk_group`` at a time, through ``model._infer``
    (on the card each group the replay of its CUDA graph: ``_chunked``),
    windows and overlap-adds them, all-reduces the accumulator and trims
    it. The JAX package's ``run(params, audio)`` takes the parameters; here
    they are the model's own (``model.net``), so ``run`` takes the audio
    alone. Every rank must call ``run`` on the same audio.
    """
    n = mesh.size()
    rank = mesh.get_local_rank(DATA_AXIS)
    group = mesh.get_group(DATA_AXIS)

    def share(n_chunks):
        return rank * n_chunks // n, (rank + 1) * n_chunks // n

    def reduce(acc):
        dist.all_reduce(acc, op=dist.ReduceOp.SUM, group=group)

    @torch.no_grad()
    def run(audio):
        audio = model._pad_for_chunks(model._to_f32(audio))
        return model._chunked(audio, bool(transcribe), share, reduce)

    return run
