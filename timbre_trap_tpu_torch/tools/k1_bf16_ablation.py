"""Where the bf16 K1 stage's time goes on the card, by ablation.

    python -m timbre_trap_tpu_torch.tools.k1_bf16_ablation [--turns 2]

The bf16 twin of ``tools/k1_f32_ablation.py`` (same runner, same chain,
stages and timing): copies of ``csrc/band_wgmma.cu`` in which one part of
``tt_band_conv_wgmma``'s epilogue is changed or left out (text
substitutions, ``VARIANTS``), timed in turns on the flagship base model's
60-stage bf16 inference chain at (4, 1080, 1024) and on three stages alone
with ELU and residual (T = 1024: the TMA epilogue). A variant that leaves
work out gives wrong outputs and only says what that work costs. Prints a
line per variant and turn, and one JSON line with the medians and the
card's name and power limit. Needs a CUDA device and ``nvcc``.
"""

import sys

import torch

from .k1_f32_ablation import ablate, turns_arg

_FINISH = "      finish_tile_tma(a, tl, epi, k, warp, lane, o0, o1);"
_EPILOGUE = ("    if constexpr (kTma)\n" + _FINISH + "\n    else\n"
             "      store_tile(a, tl, reinterpret_cast<float*>(epi.ptr), "
             "warp, lane, o0, o1);")
_COPIES = "    if (lane == 0) epilogue_copies(a, &rmap, &ymap, epi);"
_ELU = "          if (a.act) x = x > 0.f ? x : __expf(fminf(x, 0.f)) - 1.f;\n"
_TMA_STORE = "        if (pt.t0 + kBoxT * h < a.t_len)\n"
_RES_LOAD = "      if (a.res == nullptr) {\n        mbar_arrive(bar);"
_PICK = "  return tma_epi ? launch_wgmma<true>"

# name: [(text of csrc/band_wgmma.cu, its replacement), ...]
VARIANTS = {
    "base": [],
    # The mainloop alone: no residual load, no epilogue.
    "no_epilogue": [(_EPILOGUE, "    if (o0[0] == 1.2345e-30f)\n" + _FINISH),
                    (_COPIES, "")],
    "no_elu": [(_ELU, "")],
    "no_store": [(_TMA_STORE, _TMA_STORE.replace("< a.t_len", "< 0"))],
    "no_residual_load": [(_RES_LOAD, _RES_LOAD.replace("a.res == nullptr",
                                                       "true"))],
    # The staged epilogue in this kernel (ring, tiles and mainloop as they
    # are): the TMA epilogue's own A/B.
    "staged_epilogue": [(_PICK, _PICK.replace("tma_epi ?", "false ?"))],
}

_ENTRY = "tt_band_conv_wgmma"


def main(argv=None):
    return ablate(VARIANTS, _ENTRY, torch.bfloat16, turns_arg(__doc__, argv))


if __name__ == "__main__":
    sys.exit(main())
