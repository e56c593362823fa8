"""Wide&Deep CTR model — port of ``paddle_tpu.models.wide_deep``.

Sparse id fields and dense features: one shared embedding table feeds the
deep tower (an MLP over the flattened field embeddings and the dense
features), a per-id scalar table is the wide linear term.  Both tables are
``VocabParallelEmbedding`` (one card: unsharded) with the JAX package's
parameter names, shapes and N(0, 0.02²) init, so ``bridge.load_jax_params``
maps a JAX model 1:1.  ``sparse=True`` gives both tables SelectedRows
gradients inside ``Model.train_batch``; pair it with a row-mode optimizer
(``Adam(lazy_mode=True)``) and a step costs O(touched rows) whatever the
vocabulary.
"""
from __future__ import annotations

from typing import Optional

import torch

from .. import nn
from ..distributed.meta_parallel import VocabParallelEmbedding
from ..framework.device import resolve_device
from ..framework.random import default_generator
from ..nn.initializer import fills_its_layers

__all__ = ["WideDeep", "wide_deep_tiny"]


class WideDeep(nn.Layer):
    """``sparse_ids [B, F]`` integers + ``dense [B, D]`` floats → click
    logit ``[B, 1]``.  ``vocab_size`` is the hashed id space all sparse
    fields share.

    ``device`` — ``None`` runs on the CUDA card (raises
    ``UnavailableError`` when there is none), ``"cpu"`` on the CPU.
    ``generator`` — the ``torch.Generator`` the weights are drawn from, on
    the CPU in module order (default: the one
    :func:`paddle_tpu_torch.seed` reseeds)."""

    @fills_its_layers
    def __init__(self, num_fields: int = 26, vocab_size: int = 10000,
                 embed_dim: int = 16, dense_dim: int = 13,
                 hidden_sizes=(64, 32), sparse: bool = False, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_fields = num_fields
        self.dense_dim = dense_dim
        self.embedding = VocabParallelEmbedding(vocab_size, embed_dim,
                                                sparse=sparse)
        self.wide = VocabParallelEmbedding(vocab_size, 1, sparse=sparse)
        layers = []
        d = dense_dim + num_fields * embed_dim
        for h in hidden_sizes:
            layers += [nn.Linear(d, h), nn.ReLU()]
            d = h
        layers.append(nn.Linear(d, 1))
        self.deep = nn.Sequential(*layers)
        gen = generator if generator is not None else default_generator()
        for m in self.modules():
            if hasattr(m, "reset_parameters"):
                m.reset_parameters(gen)
        self.to(resolve_device(device))

    @property
    def device(self) -> torch.device:
        return self.embedding.weight.device

    def forward(self, sparse_ids, dense):
        B = sparse_ids.shape[0]
        emb = self.embedding(sparse_ids)                      # [B, F, E]
        dense = torch.as_tensor(dense, device=emb.device).to(emb.dtype)
        deep_logit = self.deep(torch.cat([dense, emb.reshape(B, -1)], 1))
        wide_logit = self.wide(sparse_ids).sum(1)             # [B, 1]
        return wide_logit + deep_logit

    def loss(self, logits, labels):
        """Sigmoid BCE with logits (the stable form), mean over the
        batch."""
        labels = torch.as_tensor(labels, device=logits.device).to(
            logits.dtype).reshape(logits.shape)
        return (logits.clamp_min(0) - logits * labels
                + torch.log1p(torch.exp(-logits.abs()))).mean()

    def predict_proba(self, logits):
        return torch.sigmoid(logits)


def wide_deep_tiny(**kw):
    cfg = dict(num_fields=4, vocab_size=64, embed_dim=8, dense_dim=4,
               hidden_sizes=(16,))
    cfg.update(kw)
    return WideDeep(**cfg)
