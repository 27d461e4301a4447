"""Decoder-only transformer entry points over the port's layers.

The counterpart of the reference package's ``models/transformer.py``: a
Python loop over the layers (the ``first_k_dense`` prefix, then the
repeated block) takes the place of ``lax.scan``, and the state is updated
in place (each entry point also returns the state, as the reference does).
Lengths, chunk starts and cache lengths are taken on the host, where the
serving loop keeps them.  A vision model's prefill takes the image as
``image_embeds`` (B, num_vision_tokens, d_model).  The serving entry
points run under ``torch.no_grad``; ``forward_train`` records a graph when
the caller enables grad and the leaves require it (``training``).

    forward_train(cfg, params, tokens, image_embeds=None, lengths=None,
                  remat=False, plain_kernels=False)
        -> (logits (B, S, V) f32, aux)
    prefill(cfg, params, state, tokens, lengths, image_embeds=None,
            start=None) -> (last_logits (B, V) f32, state)
    decode_step(cfg, params, state, last_tokens, cur_lens,
                plain_kernels=False) -> (logits (B, V) f32, state)
    greedy_generate(cfg, params, tokens, lengths, max_new,
                    image_embeds=None) -> (B, max_new)
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import ops
from repro_torch.models.ops import ApplyCtx
from repro_torch.models.params import DTYPES, Transformer, init_state


def _host_ints(x) -> np.ndarray:
    return np.asarray(x, dtype=np.int64).reshape(-1)


def _tokens(x, device) -> torch.Tensor:
    if not torch.is_tensor(x):
        x = torch.from_numpy(np.array(x, dtype=np.int64))
    return x.to(device).long()


def _apply_layer(cfg: ModelConfig, layer, x, state, ctx: ApplyCtx):
    """Residual layer = mixer (attention or MLA, cross-attention, Mamba or
    RWKV-6 time-mix) + FFN (dense, MoE or RWKV channel-mix), as its
    LayerSpec says.  Returns (x, the MoE aux loss or 0.0)."""
    lctx = dataclasses.replace(ctx, window=layer.window)
    mixer = {"attn": ops.apply_attn, "local_attn": ops.apply_attn,
             "cross_attn": ops.apply_cross_attn, "mamba": ops.apply_mamba,
             "rwkv": ops.apply_rwkv_tm}[layer.spec.mixer]
    out, state = mixer(cfg, layer, x, state, lctx)
    x = x + out
    aux = 0.0
    if layer.spec.ffn == "rwkv_cm":
        out, state = ops.apply_rwkv_cm(cfg, layer, x, state, lctx)
    elif layer.spec.ffn == "moe":
        out, aux = ops.apply_moe_ffn(cfg, layer, x)
    else:
        out = ops.apply_dense_ffn(cfg, layer, x)
    return x + out, aux


def _embed(cfg: ModelConfig, params: Transformer, tokens):
    x = params.embed[tokens]
    if cfg.scale_embeds:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype)
    return x.to(DTYPES[cfg.dtype])


def _unembed(cfg: ModelConfig, params: Transformer, x):
    x = ops.rmsnorm(x, params.final_norm, cfg.norm_plus_one)
    head = params.embed.T if cfg.tie_embeddings else params.lm_head
    logits = (x @ head.to(x.dtype)).float()
    return ops.softcap(logits, cfg.logit_softcap)


def _apply_layers(cfg: ModelConfig, layers, x, aux, states, ctx: ApplyCtx):
    """`layers` in order from (x, aux): (x, aux plus their MoE aux)."""
    for layer, st in zip(layers, states):
        x, a = _apply_layer(cfg, layer, x, st, ctx)
        aux = aux + a
    return x, aux


def _backbone(cfg: ModelConfig, params: Transformer, x, state,
              ctx: ApplyCtx, remat: bool = False):
    """Every layer in order: the ``first_k_dense`` prefix, then the blocks
    of the repeated pattern.  With `remat` each block runs under activation
    checkpointing, as the reference's ``jax.checkpoint`` of its scanned
    block body (the prefix is not checkpointed there either): its backward
    recomputes the block from its input.  Returns (x, the summed MoE aux
    loss)."""
    k, P = cfg.first_k_dense, len(cfg.block_pattern)
    layers = list(params.layers)
    x, aux = _apply_layers(cfg, layers[:k], x, 0.0, state[:k], ctx)
    for b in range(k, len(layers), P):
        run = (cfg, layers[b:b + P], x, aux, state[b:b + P], ctx)
        if remat:
            x, aux = checkpoint(_apply_layers, *run, use_reentrant=False)
        else:
            x, aux = _apply_layers(*run)
    return x, aux


def forward_train(cfg: ModelConfig, params: Transformer, tokens,
                  image_embeds=None, lengths=None, remat: bool = False,
                  plain_kernels: bool = False):
    """Full-sequence causal forward with no cache, as the reference's
    ``forward_train``: every position's logits.  `lengths` (B,) masks keys
    at or past each row's valid length.  Attention goes through the prefill
    kernel at offset 0 and RWKV-6 through the WKV6 kernel (on the CPU their
    plain versions), both differentiable; Mamba and RWKV-6 layers start
    from a zero state and write none.  `remat` checkpoints each block of
    the repeated pattern (``_backbone``);
    `plain_kernels` runs the plain versions in place of the kernels, as
    ``prefill``'s does.  Differentiable where the caller enables grad.
    Returns (logits (B, S, V) f32, aux), aux the MoE layers' summed
    load-balance loss (0 without MoE)."""
    dev = params.device
    tokens = _tokens(tokens, dev)
    B, S = tokens.shape
    ctx = _ctx("train", np.zeros(B, np.int64), S, dev, lengths,
               plain_kernels, image_embeds)
    x, aux = _backbone(cfg, params, _embed(cfg, params, tokens),
                       [None] * len(params.layers), ctx, remat)
    return _unembed(cfg, params, x), torch.as_tensor(
        aux, dtype=torch.float32, device=dev)


def _ctx(mode, starts: np.ndarray, S: int, device, lengths=None,
         plain_kernels=False, image_embeds=None) -> ApplyCtx:
    pos = starts[:, None] + np.arange(S)[None]
    return ApplyCtx(
        mode=mode,
        positions=torch.as_tensor(pos, dtype=torch.int32).to(device),
        write_idx=starts,
        lengths=None if lengths is None else torch.as_tensor(
            lengths, dtype=torch.int32).to(device),
        image_embeds=None if image_embeds is None else torch.as_tensor(
            image_embeds).to(device),
        plain_kernels=plain_kernels)


@torch.no_grad()
def prefill(cfg: ModelConfig, params: Transformer, state, tokens, lengths,
            image_embeds=None, start=None, plain_kernels: bool = False):
    """Prompt processing; fills `state` at offset `start` (default 0).

    `lengths` is the ABSOLUTE valid length (start + valid tokens in this
    chunk): chunked prefill passes consecutive windows with increasing
    `start`.  `image_embeds` (B, num_vision_tokens, d_model) feeds the
    cross-attention layers, which keep its keys / values in the state.
    `plain_kernels` runs the plain versions (masked _sdpa, chunked WKV6)
    in place of the kernels, to hold the kernels' logits against them on
    the card.
    Returns (last_token_logits (B,V), state)."""
    dev = params.device
    tokens = _tokens(tokens, dev)
    B, S = tokens.shape
    lengths = _host_ints(lengths)
    start = np.zeros(B, np.int64) if start is None else _host_ints(start)
    ctx = _ctx("prefill", start, S, dev, lengths, plain_kernels,
               image_embeds)
    x, _ = _backbone(cfg, params, _embed(cfg, params, tokens), state, ctx)
    # unembed ONLY the last valid position, as the reference does
    idx = np.clip(lengths - start - 1, 0, S - 1)
    x_last = x[torch.arange(B, device=dev),
               torch.as_tensor(idx).to(dev)][:, None]
    return _unembed(cfg, params, x_last)[:, 0], state


@torch.no_grad()
def decode_step(cfg: ModelConfig, params: Transformer, state, last_tokens,
                cur_lens, plain_kernels: bool = False):
    """One autoregressive step against the cache.

    last_tokens: (B,) ints; cur_lens: (B,) tokens already cached (host).
    `plain_kernels` as ``prefill``'s.
    Returns (logits (B,V), state)."""
    dev = params.device
    tokens = _tokens(last_tokens, dev)[:, None]
    ctx = _ctx("decode", _host_ints(cur_lens), 1, dev,
               plain_kernels=plain_kernels)
    x, _ = _backbone(cfg, params, _embed(cfg, params, tokens), state, ctx)
    return _unembed(cfg, params, x)[:, 0], state


@torch.no_grad()
def greedy_generate(cfg: ModelConfig, params: Transformer, tokens, lengths,
                    max_new: int, image_embeds=None) -> torch.Tensor:
    """Reference generation loop (tests / examples): (B, max_new) int64."""
    B, S = tokens.shape
    state = init_state(cfg, B, S + max_new, params.device)
    logits, state = prefill(cfg, params, state, tokens, lengths,
                            image_embeds)
    cur = _host_ints(lengths)
    tok = logits.argmax(-1)
    out = []
    for _ in range(max_new):
        out.append(tok)
        logits, state = decode_step(cfg, params, state, tok, cur)
        tok = logits.argmax(-1)
        cur = cur + 1
    return torch.stack(out, dim=1)
