"""The plain reference of what each cell's timed path produces.

* ``Reference.activations`` / ``mask`` / ``reconstruct``: one request of
  the transcription or reconstruction cells. A clip is padded to whole
  blocks and by half a block on each side; chunks of one block at a
  half-block hop go through the sliCQ analysis and the network; each
  output is weighted by a Hann window of M frames and added at its frame
  offset (50 % overlap-add); the half-block margins are trimmed.
  Transcription: tanh of the magnitude, then the peak mask (a bin kept
  where it is strictly above both neighbours in frequency, then >= 0.5).
  Reconstruction: the sliCQ synthesis, divided by its largest magnitude.
* ``Reference.train``: the first steps of the training recipe: the three
  objectives composed as the published trainer composes them, the
  gradients by autograd, and AdamW (clip by global norm, then Adam, then
  decoupled weight decay) under the cosine warm-up.

Everything runs in float32 with TF32 off, unless a control rounds the
convs' operands (``quant``). Nothing here imports the program: the
inputs and the weights are the harness's, and every table the program
derives from them is derived again here.
"""

import contextlib

import numpy as np
import torch

from .net import TimbreTrapNet
from .slicq import Slicq

__all__ = ["Reference", "ieee", "peak_mask", "cosine_warmup",
           "OBJECTIVES"]

OBJECTIVES = ("loss/reconstruction", "loss/transcription",
              "loss/consistency/spectral", "loss/consistency/score",
              "loss/total")
_EPS = float(torch.finfo(torch.float32).eps)


@contextlib.contextmanager
def ieee():
    """float32 matmuls and convolutions without TF32 inside the block."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    old = cudnn.allow_tf32, matmul.allow_tf32
    cudnn.allow_tf32 = matmul.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = old


def peak_mask(activations, t=0.5):
    """(..., F, T) -> uint8: kept where strictly above both frequency
    neighbours (zero past the edges), then >= t."""
    p = torch.nn.functional.pad(activations, (0, 0, 1, 1))
    mid = p[..., 1:-1, :]
    peak = (mid > p[..., :-2, :]) & (mid > p[..., 2:, :])
    kept = torch.where(peak, activations, torch.zeros_like(activations))
    return (kept >= t).to(torch.uint8)


def cosine_warmup(n_steps, step):
    """The published warm-up's scaling after ``step`` completed steps."""
    if n_steps <= 0:
        return 1.0
    curr = 1 + min(float(step), float(n_steps))
    return float(np.float32(1.0 - 0.5 * (1.0 + np.cos(curr * np.pi
                                                       / (n_steps + 1)))))


def _recon_loss(estimate, target):
    return torch.mean(torch.sum(torch.square(estimate - target),
                                dim=(-3, -2)))


def _transcription_loss(estimate, target):
    """Squared error with the positive class weighted per frame by the
    ratio of negative to positive cells."""
    loss = torch.square(estimate - target)
    positive = torch.sum(target, dim=-2, keepdim=True)
    negative = torch.sum(1.0 - target, dim=-2, keepdim=True)
    scaling = torch.where(target == 1, negative / (positive + _EPS), 0.0)
    scaling = torch.where(scaling == 0, 1.0, scaling)
    return torch.mean(torch.sum(loss * scaling, dim=-2))


class Reference:
    """The reference of one configuration, with the harness's weights."""

    def __init__(self, config, state_dict, device, quant=None):
        m = config["model"]
        self.device = torch.device(device)
        self.slicq = Slicq(m["sample_rate"], m["n_octaves"],
                           m["bins_per_octave"], m["secs_per_block"],
                           self.device)
        self.net = TimbreTrapNet(self.slicq.F, m["latent_size"],
                                 m["model_complexity"],
                                 m["skip_connections"]).to(self.device)
        self.net.load_state_dict(state_dict, strict=True)
        self.net.set_quant(quant)
        self.window = torch.as_tensor(np.hanning(self.slicq.M),
                                      dtype=torch.float32, device=self.device)

    def _features(self, audio):
        c = self.slicq.encode(audio)[:, 0]
        return torch.stack([c.real, c.imag], dim=1)

    @torch.no_grad()
    def coefficients(self, clip, transcribe, group=8):
        """(N,) host clip -> (1, 2, F, n_blocks * M) by overlap-add."""
        L, M = self.slicq.L, self.slicq.M
        hop = L // 2
        audio = torch.as_tensor(np.asarray(clip, np.float32),
                                device=self.device).reshape(1, -1)
        audio = torch.nn.functional.pad(audio, (hop, -audio.shape[-1] % L
                                                + hop))
        n_chunks = (audio.shape[-1] - hop) // hop
        n_frames = (audio.shape[-1] // L) * M
        acc = torch.zeros((2, self.slicq.F, n_frames + 2 * M),
                          dtype=torch.float32, device=self.device)
        with ieee():
            for g0 in range(0, n_chunks, group):
                ks = range(g0, min(g0 + group, n_chunks))
                chunks = torch.stack([audio[:, k * hop:k * hop + L]
                                      for k in ks])
                latents, skips = self.net.encode(self._features(chunks))
                out = self.net.decode(latents, skips, transcribe) * self.window
                for i, k in enumerate(ks):
                    acc[..., k * (M // 2):k * (M // 2) + M] += out[i]
        return acc[None, ..., M // 2:n_frames - M // 2]

    def activations(self, clip):
        """(1, F, T) activations in [0, 1]."""
        c = self.coefficients(clip, True)
        return torch.tanh(torch.linalg.vector_norm(c, dim=1))

    @torch.no_grad()
    def reconstruct(self, clip):
        """(1, 1, n_blocks * L) audio, divided by its largest magnitude."""
        c = self.coefficients(clip, False)
        y = self.slicq.decode(torch.complex(c[:, 0], c[:, 1])[:, None])
        peak = y.abs().max()
        return torch.where(peak > 0, y / peak, y)

    def train(self, batches, lrs, recipe):
        """Run ``len(batches)`` steps from the weights given. Each batch is
        (int16 audio on the ±8 grid, uint8 ground truth). Returns each
        step's losses, the first step's gradients as the optimizer takes
        them (after the clip), and the parameters after the last step."""
        params = dict(self.net.named_parameters())
        mu = {n: torch.zeros_like(p) for n, p in params.items()}
        nu = {n: torch.zeros_like(p) for n, p in params.items()}
        b1, b2, eps = 0.9, 0.999, 1e-8
        losses, first = [], None
        for count, ((audio, gt), lr) in enumerate(zip(batches, lrs), 1):
            x = torch.as_tensor(audio, device=self.device).to(torch.float32)
            x = x * (1.0 / recipe["audio_scale"])
            gt = torch.as_tensor(gt, device=self.device).to(torch.float32)
            gt = gt * (1.0 / 255.0)
            m = gt.shape[0]
            with ieee():
                feats = self._features(x)
                total, terms = self._losses(feats, gt, m)
                grads = torch.autograd.grad(total, list(params.values()))
            losses.append({k: float(v.detach()) for k, v in terms.items()})
            with torch.no_grad():
                grads = dict(zip(params, grads))
                norm = torch.sqrt(sum(torch.sum(torch.square(g))
                                      for g in grads.values()))
                keep = norm < recipe["grad_clip"]
                bc1 = 1.0 - b1 ** count
                bc2 = 1.0 - b2 ** count
                for n, p in params.items():
                    g = torch.where(keep, grads[n],
                                    grads[n] / norm * recipe["grad_clip"])
                    mu[n].mul_(b1).add_((1 - b1) * g)
                    nu[n].mul_(b2).add_((1 - b2) * torch.square(g))
                    u = (mu[n] / bc1) / (torch.sqrt(nu[n] / bc2) + eps)
                    p.sub_(float(lr) * (u + recipe["weight_decay"] * p))
                if count == 1:
                    first = {n: v / (1 - b1) for n, v in mu.items()}
        after = {n: p.detach().clone() for n, p in params.items()}
        return losses, first, after

    def _losses(self, feats, gt, m):
        net = self.net
        latents, skips = net.encode(feats)
        rec = net.decode(latents, skips, False)
        trn = net.decode(latents, skips, True)
        latents_t, skips_t = net.encode(trn)
        trn_rec = net.decode(latents_t, skips_t, False)
        trn_scr = net.decode(latents_t, skips_t, True)
        activations = torch.tanh(torch.linalg.vector_norm(trn, dim=1))
        terms = {
            "loss/reconstruction": _recon_loss(rec, feats),
            "loss/transcription": _transcription_loss(activations[:m], gt),
            "loss/consistency/spectral": _recon_loss(trn_rec[:m], trn[:m]),
            "loss/consistency/score": _recon_loss(trn_scr[:m], trn[:m]),
        }
        total = (terms["loss/reconstruction"] + terms["loss/transcription"]
                 + terms["loss/consistency/spectral"]
                 + terms["loss/consistency/score"])
        terms["loss/total"] = total
        return total, terms
