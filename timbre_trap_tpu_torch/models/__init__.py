from .fused import forward_spec, fused_forward, packed_to_nchw
from .modules import TimbreTrapNet, embedding_sizes
from .timbre_trap import (TimbreTrap, TimbreTrapFiLM, TimbreTrapMag,
                          TimbreTrapMagDB, load_model)

__all__ = ["TimbreTrap", "TimbreTrapFiLM", "TimbreTrapMag", "TimbreTrapMagDB",
           "load_model", "TimbreTrapNet", "embedding_sizes", "forward_spec",
           "fused_forward", "packed_to_nchw"]
