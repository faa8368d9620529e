"""Model facade: embeddings + stack + head, the full-sequence forward and
one-token decode.

``build_model(cfg)`` returns a :class:`Model` whose methods are functions of
(params, inputs).  Parameters are plain dicts and lists of tensors with the
reference's names, on the device the caller chose; ``loss`` is
differentiable in them (the train step takes its gradients with autograd).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import blas
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

__all__ = ["AUX_LOSS_WEIGHT", "Model", "build_model", "cross_entropy"]

AUX_LOSS_WEIGHT = 0.01


def _dtype_of(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean token CE in fp32.  logits: (B, S, V); labels: (B, S) int.

    The reference picks the label's log-prob with a one-hot mask and a sum
    (which partitions over a vocab-sharded axis); on one device a gather
    reads the same value exactly (a sum of one term and zeros)."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    ll = torch.gather(lf, -1, labels.long()[..., None])[..., 0]
    return torch.mean(lse - ll)


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig

    # ---- params -----------------------------------------------------------
    def init_params(self, gen: torch.Generator, *, device) -> Dict[str, Any]:
        """Random weights from ``gen`` (a generator on ``device``) with the
        reference's distributions: N(0, 1)·fan_in**-0.5 for dense weights,
        N(0, 1)·d_model**-0.5 for the embedding, ones for norm scales (zeros
        for biases).  An embedding-input arch has no ``embed``."""
        cfg = self.cfg
        dtype = _dtype_of(cfg)
        params: Dict[str, Any] = {
            "stack": T.init_stack(gen, cfg, dtype, device=device),
            "final_norm": L.init_norm(cfg.d_model, dtype, device=device,
                                      kind=cfg.norm_kind),
        }
        if cfg.embed_inputs:
            params["embed"] = L.init_dense(
                gen, cfg.vocab_size, cfg.d_model, dtype, device=device,
                scale=cfg.d_model ** -0.5)
        if not (cfg.tie_embeddings and cfg.embed_inputs):
            params["head"] = L.init_dense(
                gen, cfg.d_model, cfg.vocab_size, dtype, device=device)
        return params

    # ---- pieces -------------------------------------------------------------
    def _embed(self, params, batch) -> Tuple[torch.Tensor, torch.Tensor]:
        """The reference's batch dict -> (embeddings (B, S, D), positions).

        ``batch`` holds ``tokens`` (B, S) int for a token-input arch or
        ``embeds`` (B, S, D) for an embedding-input one (audio / vlm stub
        frontends), and optionally ``positions``: (B, S), or (3, B, S) for
        M-RoPE.  Positions default to 0..S-1 for every row (every stream,
        for M-RoPE: text tokens carry identical streams)."""
        cfg = self.cfg
        if cfg.embed_inputs:
            tokens = batch["tokens"]
            x = params["embed"][tokens]
            bsz, s = tokens.shape
        else:
            x = batch["embeds"]
            bsz, s = x.shape[0], x.shape[1]
        positions = batch.get("positions")
        if positions is None:
            lead = (3, bsz, s) if cfg.mrope else (bsz, s)
            positions = torch.arange(s, dtype=torch.int32,
                                     device=x.device).expand(*lead)
        return x, positions

    def _head(self, params, x) -> torch.Tensor:
        cfg = self.cfg
        x = L.apply_norm(x, params["final_norm"], cfg.norm_eps, cfg.norm_kind)
        if cfg.tie_embeddings and cfg.embed_inputs:
            return blas.matmul(x, params["embed"].T)
        return blas.matmul(x, params["head"])

    # ---- forward ------------------------------------------------------------
    def forward(self, params, batch, *,
                positions: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(logits (B, S, V), aux_loss) — training / prefill.  ``batch`` is
        the reference's dict (``tokens`` or ``embeds``, optional
        ``positions``; see :meth:`_embed`), or a (B, S) int tensor of
        tokens, with ``positions`` beside it."""
        if isinstance(batch, torch.Tensor):
            batch = {"tokens": batch}
        if positions is not None:
            batch = {**batch, "positions": positions}
        x, positions = self._embed(params, batch)
        x, aux = T.apply_stack(params["stack"], x, self.cfg,
                               positions=positions)
        return self._head(params, x), aux

    def loss(self, params, batch) -> torch.Tensor:
        """Mean token CE of the forward's logits against ``batch["labels"]``
        plus ``AUX_LOSS_WEIGHT`` times the MoE router's loss (fp32)."""
        logits, aux = self.forward(params, batch)
        return cross_entropy(logits, batch["labels"]) + AUX_LOSS_WEIGHT * aux

    # ---- decode --------------------------------------------------------------
    def init_decode_cache(self, batch_size: int, cache_len: int, *, device):
        return T.init_decode_cache(
            self.cfg, batch_size, cache_len, _dtype_of(self.cfg),
            device=device)

    def decode_step(self, params, cache, tokens, cache_index):
        """One token: tokens (B, 1) int (or embeddings (B, 1, D) for an
        embedding-input arch); cache_index int.  Returns (logits (B, V),
        cache) — the cache is updated in place."""
        cfg = self.cfg
        x = params["embed"][tokens] if cfg.embed_inputs else tokens
        x, cache = T.decode_stack(params["stack"], cache, x, cache_index,
                                  cfg)
        logits = self._head(params, x)
        return logits[:, 0, :], cache


def build_model(cfg: ArchConfig) -> Model:
    return Model(cfg)
