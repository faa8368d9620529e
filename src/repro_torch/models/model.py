"""Model facade: embeddings + stack + head, the full-sequence forward and
one-token decode.

``build_model(cfg)`` returns a :class:`Model` whose methods are functions of
(params, inputs).  Parameters are plain dicts and lists of tensors with the
reference's names, on the device the caller chose.

``loss`` arrives with the training slice.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import blas
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

__all__ = ["Model", "build_model"]


def _dtype_of(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig

    # ---- params -----------------------------------------------------------
    def init_params(self, gen: torch.Generator, *, device) -> Dict[str, Any]:
        """Random weights from ``gen`` (a generator on ``device``) with the
        reference's distributions: N(0, 1)·fan_in**-0.5 for dense weights,
        N(0, 1)·d_model**-0.5 for the embedding, ones for norm scales."""
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
    def _embed(self, params, tokens: torch.Tensor) -> torch.Tensor:
        """Token ids (B, S) -> embeddings (B, S, D)."""
        if not self.cfg.embed_inputs:
            raise NotImplementedError(
                "embedding-input (audio / vlm) frontends arrive with their "
                "configs")
        return params["embed"][tokens]

    def _head(self, params, x) -> torch.Tensor:
        cfg = self.cfg
        x = L.apply_norm(x, params["final_norm"], cfg.norm_eps, cfg.norm_kind)
        if cfg.tie_embeddings and cfg.embed_inputs:
            return blas.matmul(x, params["embed"].T)
        return blas.matmul(x, params["head"])

    # ---- forward ------------------------------------------------------------
    def forward(self, params, tokens: torch.Tensor, *,
                positions: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(logits (B, S, V), aux_loss) — training / prefill.  tokens:
        (B, S) int; positions default to 0..S-1 for every row."""
        x = self._embed(params, tokens)
        bsz, s = tokens.shape
        if positions is None:
            positions = torch.arange(s, dtype=torch.int32,
                                     device=tokens.device).expand(bsz, s)
        x, aux = T.apply_stack(params["stack"], x, self.cfg,
                               positions=positions)
        return self._head(params, x), aux

    # ---- decode --------------------------------------------------------------
    def init_decode_cache(self, batch_size: int, cache_len: int, *, device):
        return T.init_decode_cache(
            self.cfg, batch_size, cache_len, _dtype_of(self.cfg),
            device=device)

    def decode_step(self, params, cache, tokens, cache_index):
        """One token: tokens (B, 1) int; cache_index int.  Returns
        (logits (B, V), cache) — the cache is updated in place."""
        x = self._embed(params, tokens)
        x, cache = T.decode_stack(params["stack"], cache, x, cache_index,
                                  self.cfg)
        logits = self._head(params, x)
        return logits[:, 0, :], cache


def build_model(cfg: ArchConfig) -> Model:
    return Model(cfg)
