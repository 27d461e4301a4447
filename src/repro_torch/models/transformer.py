"""Decoder-only transformer entry points over the port's layers.

The counterpart of the reference package's ``models/transformer.py``: a
Python loop over the layers (the ``first_k_dense`` prefix, then the
repeated block) takes the place of ``lax.scan``, and the state is updated
in place (each entry point also returns the state, as the reference does).
Under ``sharding.axis_rules(rules, mesh)`` a model built with its vocab
split (``init_params(..., mesh, rules)``) embeds vocab-parallel (each rank
looks up the tokens of its rows, the rows summed over the split) and
unembeds to its vocab slice of the logits; the entry points still return
whole logits, gathered (``forward_train_local`` keeps the slice, for the
vocab-parallel loss).  A model built with its "embed" dim split over the
FSDP axes (the reference's ``param_rules`` for train and prefill) gathers
each layer's leaves, and the embedding and head, before it uses them
(``_fsdp``).
Lengths, chunk starts and cache lengths are taken on the host, where the
serving loop keeps them.  A vision model's prefill takes the image as
``image_embeds`` (B, num_vision_tokens, d_model).  The serving entry
points run under ``torch.no_grad``; ``forward_train`` records a graph when
the caller enables grad and the leaves require it (``training``).

    forward_train(cfg, params, tokens, image_embeds=None, lengths=None,
                  remat=False, plain_kernels=False)
        -> (logits (B, S, V) f32, aux)
    forward_train_local(...) -> (logits (B, S, V / n) f32, aux, vocab split)
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
from repro_torch.sharding import axis_rules, current_mesh, current_rules


def _host_ints(x) -> np.ndarray:
    return np.asarray(x, dtype=np.int64).reshape(-1)


def _tokens(x, device) -> torch.Tensor:
    if not torch.is_tensor(x):
        x = torch.from_numpy(np.array(x, dtype=np.int64))
    return x.to(device).long()


class _Gathered:
    """A module read with some of its leaves replaced by their gathered
    values (``_fsdp``), and the rules those say it was built under."""

    def __init__(self, mod, leaves: dict, rules: dict):
        self._mod = mod
        self.__dict__.update(leaves)
        self.shard_rules = rules

    def __getattr__(self, name):
        return getattr(self._mod, name)


def _fsdp(mod, names=None):
    """`mod` with each of its leaves (of `names`, or all) whose "embed" dim
    the build split over the FSDP axes gathered whole along that dim
    (``ops._Gather``: backward, the gradient summed over those ranks and
    cut back to this rank's shard, a reduce-scatter), read as a module
    built with "embed" whole; `mod` itself where no leaf is so split.  A
    gathered leaf is still the rank's tensor-parallel shard, so the layer
    code after it sees what it sees without FSDP.  Expert d_ff FSDP
    ("expert_ff") is not touched: ``ops._expert_weights`` gathers it."""
    mesh = current_mesh()
    rules = getattr(mod, "shard_rules", None)
    if mesh is None or not rules or not rules.get("embed"):
        return mod
    got = {}
    for name, lf in mod.leaves.items():
        if "embed" in lf.axes and (names is None or name in names):
            dim = lf.axes.index("embed")
            sp = ops.leaf_split(mod, name, dim, mesh)
            if sp is not None:
                got[name] = ops._Gather.apply(getattr(mod, name), sp, dim,
                                              True)
    return _Gathered(mod, got, {**rules, "embed": ()}) if got else mod


def _apply_layer(cfg: ModelConfig, layer, x, state, ctx: ApplyCtx):
    """Residual layer = mixer (attention or MLA, cross-attention, Mamba or
    RWKV-6 time-mix) + FFN (dense, MoE or RWKV channel-mix), as its
    LayerSpec says, on the layer's leaves with their FSDP shards gathered
    (``_fsdp``: under ``remat`` the gather reruns in the checkpointed
    block's backward, so one block's gathered leaves live at a time).
    Returns (x, the MoE aux loss or 0.0)."""
    layer = _fsdp(layer)
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
    params = _fsdp(params, ("embed",))
    sv = ops.leaf_split(params, "embed", 0, current_mesh())
    if sv is None:
        x = params.embed[tokens]
    else:
        # this rank's rows [v0, v0 + V_local): its tokens looked up, zeros
        # for the rest, summed over the split (one term is not zero)
        V = params.embed.shape[0]
        loc = tokens - sv.i * V
        mine = (loc >= 0) & (loc < V)
        x = torch.where(mine[..., None], params.embed[loc.clamp(0, V - 1)],
                        0.0)
        x = ops._Leave.apply(x, sv.group)
    if cfg.scale_embeds:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype)
    return x.to(DTYPES[cfg.dtype])


def _unembed_local(cfg: ModelConfig, params: Transformer, x):
    """(logits of this rank's vocab slice, f32 after the softcap; the
    vocab's Split, or None where the head is whole)."""
    params = _fsdp(params, ("embed",) if cfg.tie_embeddings
                   else ("lm_head",))
    x = ops.rmsnorm(x, params.final_norm, cfg.norm_plus_one)
    head = params.embed.T if cfg.tie_embeddings else params.lm_head
    sv = ops.leaf_split(params, *(("embed", 0) if cfg.tie_embeddings
                                  else ("lm_head", 1)), current_mesh())
    if sv is not None:
        x = ops._Enter.apply(x, sv.group)
    logits = (x @ head.to(x.dtype)).float()
    return ops.softcap(logits, cfg.logit_softcap), sv


def _unembed(cfg: ModelConfig, params: Transformer, x):
    """Whole logits: a vocab slice gathered over its split (every rank
    uses the whole alike: its gradient is the rank's slice)."""
    logits, sv = _unembed_local(cfg, params, x)
    if sv is None:
        return logits
    return ops._Gather.apply(logits, sv, logits.dim() - 1, False)


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
    under = (current_rules(), current_mesh())
    for b in range(k, len(layers), P):
        run = (cfg, layers[b:b + P], x, aux, state[b:b + P], ctx)
        if remat:
            x, aux = checkpoint(_remat_block, under, *run,
                                use_reentrant=False)
        else:
            x, aux = _apply_layers(*run)
    return x, aux


def _remat_block(under, *run):
    """``_apply_layers`` under the rules and mesh `under` that were active
    at its forward: the checkpoint reruns it in the backward, which on a
    card runs on autograd's device thread, where the thread-local
    ``sharding.axis_rules`` of the caller is not active."""
    rules, mesh = under
    if rules is None:
        return _apply_layers(*run)
    with axis_rules(rules, mesh):
        return _apply_layers(*run)


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
    logits, aux, sv = forward_train_local(cfg, params, tokens, image_embeds,
                                          lengths, remat, plain_kernels)
    if sv is not None:
        logits = ops._Gather.apply(logits, sv, 2, False)
    return logits, aux


def forward_train_local(cfg: ModelConfig, params: Transformer, tokens,
                        image_embeds=None, lengths=None, remat: bool = False,
                        plain_kernels: bool = False):
    """``forward_train`` with the logits of this rank's vocab slice: (logits
    (B, S, V / n) f32, aux, the vocab's ``ops.Split``, or None and whole
    logits where the head is whole)."""
    dev = params.device
    tokens = _tokens(tokens, dev)
    B, S = tokens.shape
    ctx = _ctx("train", np.zeros(B, np.int64), S, dev, lengths,
               plain_kernels, image_embeds)
    x, aux = _backbone(cfg, params, _embed(cfg, params, tokens),
                       [None] * len(params.layers), ctx, remat)
    logits, sv = _unembed_local(cfg, params, x)
    return logits, torch.as_tensor(aux, dtype=torch.float32,
                                   device=dev), sv


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
