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

from repro_torch.configs.base import ArchConfig, ShapeConfig
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

    def param_specs(self) -> Dict[str, Any]:
        """The parameters' shapes and dtypes as meta tensors (the
        reference's ``ShapeDtypeStruct`` tree; one leaf a layer)."""
        return self.init_params(torch.Generator(), device="meta")

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
            x = self._lookup(params, tokens)
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

    def _lookup(self, params, tokens) -> torch.Tensor:
        """The embedding rows of ``tokens``, times ``embedding_multiplier``
        (granite-4.0-h; at 1.0 no multiply is launched)."""
        x = params["embed"][tokens]
        em = self.cfg.embedding_multiplier
        return x if em == 1.0 else x * em

    def _head(self, params, x) -> torch.Tensor:
        """Final norm and the (tied) head, the logits divided by
        ``logits_scaling`` (granite-4.0-h; at 1.0 nothing is launched)."""
        cfg = self.cfg
        x = L.apply_norm(x, params["final_norm"], cfg.norm_eps, cfg.norm_kind)
        if cfg.tie_embeddings and cfg.embed_inputs:
            logits = blas.matmul(x, params["embed"].T)
        else:
            logits = blas.matmul(x, params["head"])
        ls = cfg.logits_scaling
        return logits if ls == 1.0 else logits / ls

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
        x = self._lookup(params, tokens) if cfg.embed_inputs else tokens
        x, cache = T.decode_stack(params["stack"], cache, x, cache_index,
                                  cfg)
        logits = self._head(params, x)
        return logits[:, 0, :], cache

    # ---- dry-run input specs ---------------------------------------------------
    def input_specs(self, shape: ShapeConfig) -> Dict[str, Any]:
        """Meta-tensor stand-ins for every model input of this cell, under
        the reference's keys.  A decode cell's ``cache_index`` is a 0-d
        int32 CPU tensor holding the cache's last slot (``seq_len - 1``):
        the decode path reads it on the host, which a meta tensor cannot
        give."""
        cfg = self.cfg
        b, s = shape.global_batch, shape.seq_len
        i32 = torch.int32
        dt = _dtype_of(cfg)

        def spec(*dims, dtype=i32):
            return torch.empty(dims, dtype=dtype, device="meta")

        if shape.kind in ("train", "prefill"):
            specs: Dict[str, Any] = {}
            if cfg.embed_inputs:
                specs["tokens"] = spec(b, s)
            else:
                specs["embeds"] = spec(b, s, cfg.d_model, dtype=dt)
            if cfg.mrope:
                specs["positions"] = spec(3, b, s)
            if shape.kind == "train":
                specs["labels"] = spec(b, s)
            return specs
        # decode: one new token against a cache of length s
        tok = spec(b, 1) if cfg.embed_inputs else spec(b, 1, cfg.d_model,
                                                        dtype=dt)
        return {
            "tokens": tok,
            "cache": self.init_decode_cache(b, s, device="meta"),
            "cache_index": torch.tensor(s - 1, dtype=i32),
        }


def build_model(cfg: ArchConfig) -> Model:
    return Model(cfg)
