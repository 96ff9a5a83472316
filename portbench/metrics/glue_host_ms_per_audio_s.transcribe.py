"""The host's time in the streaming and skip-route glue, in milliseconds
an audio second: the self time of ``tt.transcribe`` and of every port
span but the chain, the spec builds, the kernels', the caches', the
builds' and the training step's. That is the piece stream, the analysis,
each forward's own work (its stack, and the packing in and out of the
chain), the overlap-add, the activations, the concatenation, and the
skip route's bridge and adds."""

from portbench import spans

# Spans of other layers: the chain, K1, K2, cache misses, builds.
NOT_GLUE = ("tt.chain", "tt.k1", "tt.k2", "tt.prepare", "tt.build",
            "tt.spec_build")
# Prefixes of the training step's, the Trainer's and K3's spans.
NOT_GLUE_PREFIXES = ("tt.step.", "tt.loader.", "tt.k3.")


def read(ctx):
    rec = spans.record()
    if not rec or "tt.transcribe" not in rec:
        return None
    glue = sum(v["self_s"] for name, v in rec.items()
               if name.startswith("tt.") and name not in NOT_GLUE
               and not name.startswith(NOT_GLUE_PREFIXES))
    return 1e3 * glue / ctx["work"]["audio_s"]
