"""The port's serving stack on the rest of the layer zoo against the
reference package: MLA's latent cache (DeepSeek-V2-Lite), MoE with a dense
prefix layer (Kimi K2), Mamba's recurrent state beside an attention layer
(Jamba), and cross-attention to a per-request image (Llama-3.2-Vision).
Greedy tokens of ``Engine`` (whole prompts, queueing, convertible chunks,
a chunked Jamba request in a reused slot) and ``PDCluster`` EQUAL
``repro.models.greedy_generate``'s on the same weights (SMOKE size,
test_torch_zoo.py's noisy reference weights).  The vision model serves
through an ``Engine`` with ``chunk_size=0``: the reference's chunked step
and prefiller pass no image.  Payload sizes equal the reference's
``payload_bytes``, ``kvtransfer.transfer`` equals the reference's, and
``abstract_state`` has the reference's leaves, shapes and dtypes.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as jm
from repro import serving as jserving
from repro.configs import ARCH_IDS
from repro.configs import get_config as jget_config
from repro_torch import models as tm
from repro_torch.configs import get_config
from repro_torch.core import CHIPS, InstanceSpec, TokenScalePolicy, profile
from repro_torch.serving import (Engine, PDCluster, Request, TransferStats,
                                 extract, insert, payload_bytes, transfer)
from test_torch_zoo import images, pair

MAX_NEW = 6
PROMPT_LENS = (7, 12, 5, 20, 9)
SERVED = ["deepseek_v2_lite_16b", "kimi_k2_1t_a32b", "jamba_v0_1_52b"]


def _reference_tokens(jcfg, jparams, prompts, ie=None):
    """One batched reference run (rows padded to the longest prompt)."""
    lens = [len(p) for p in prompts]
    toks = np.zeros((len(prompts), max(lens)), np.int32)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = p
    return np.asarray(jm.greedy_generate(
        jcfg, jparams, jnp.asarray(toks), jnp.asarray(lens, jnp.int32),
        MAX_NEW, None if ie is None else jnp.asarray(ie)))


@functools.lru_cache(maxsize=None)
def _served(arch):
    cfg, model, jcfg, jparams = pair(arch)
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab_size, size=(L,)).astype(np.int32)
               for L in PROMPT_LENS]
    return arch, cfg, model, prompts, _reference_tokens(jcfg, jparams,
                                                        prompts)


@pytest.fixture(scope="module", params=SERVED)
def setup(request):
    return _served(request.param)


@pytest.mark.parametrize("kw", [
    dict(num_slots=4, max_len=64),
    dict(num_slots=2, max_len=64),                  # queueing
    dict(num_slots=2, max_len=64, chunk_size=8),    # convertible
], ids=["4slots", "2slots", "convertible"])
def test_engine_tokens_equal_reference(setup, kw):
    _, cfg, model, prompts, refs = setup
    eng = Engine(cfg, model, **kw)
    reqs = [Request(rid=i, prompt=p, max_new_tokens=MAX_NEW)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.add_request(r)
    eng.run_until_drained()
    for r, ref in zip(reqs, refs):
        assert np.array_equal(np.array(r.output), ref), r.rid
    if kw.get("chunk_size"):
        assert eng.mixed_steps > 0


def test_pd_cluster_tokens_equal_reference(setup):
    arch, cfg, model, prompts, refs = setup
    prof = profile(get_config(arch), InstanceSpec(CHIPS["h100"], 1))
    cl = PDCluster(cfg, model, TokenScalePolicy(prof, convertible=1),
                   n_prefillers=1, n_decoders=1, n_convertible=1,
                   max_len=64, chunk_size=8)
    reqs = [Request(rid=i, prompt=p, max_new_tokens=MAX_NEW)
            for i, p in enumerate(prompts)]
    for r in reqs:
        cl.submit(r)
    cl.run_until_drained()
    for r, ref in zip(reqs, refs):
        assert np.array_equal(np.array(r.output), ref), r.rid
    assert cl.transfers.n_transfers >= 1


def test_jamba_chunked_request_in_a_reused_slot():
    """Mamba's ssm / conv states in a reused slot: with 2 slots and chunks
    of 8, the 20-token prompt is chunked into a slot that an earlier
    request used (and whose state every decode step since has advanced);
    its first chunk must start from a zeroed state (ROADMAP C2)."""
    _, cfg, model, prompts, refs = _served("jamba_v0_1_52b")
    eng = Engine(cfg, model, num_slots=2, max_len=64, chunk_size=8)
    slots = {}
    alloc = eng._alloc_slot

    def record(req):
        slot = alloc(req)
        slots.setdefault(slot, []).append(req.rid)
        return slot
    eng._alloc_slot = record
    reqs = [Request(rid=i, prompt=p, max_new_tokens=MAX_NEW)
            for i, p in enumerate(prompts[:4])]
    for r in reqs:
        eng.add_request(r)
    eng.run_until_drained()
    reused = [rids for rids in slots.values() if 3 in rids][0]
    assert reused.index(3) > 0, slots           # not the slot's first user
    assert eng.mixed_steps > 0
    for r, ref in zip(reqs, refs):
        assert np.array_equal(np.array(r.output), ref), r.rid


@pytest.fixture(scope="module")
def vision():
    cfg, model, jcfg, jparams = pair("llama_3_2_vision_11b")
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab_size, size=(L,)).astype(np.int32)
               for L in PROMPT_LENS]
    ie = images(cfg, len(prompts), seed=11)
    return cfg, model, prompts, ie, _reference_tokens(jcfg, jparams,
                                                      prompts, ie)


@pytest.mark.parametrize("slots", [4, 2], ids=["4slots", "2slots"])
def test_vision_engine_tokens_equal_reference(vision, slots):
    """Each request carries its own image (Request.image_embeds); the
    engine's prefill passes it to the cross-attention layers, whose keys /
    values then live in the request's slot for decode."""
    cfg, model, prompts, ie, refs = vision
    eng = Engine(cfg, model, num_slots=slots, max_len=64)
    reqs = [Request(rid=i, prompt=p, max_new_tokens=MAX_NEW,
                    image_embeds=ie[i]) for i, p in enumerate(prompts)]
    for r in reqs:
        eng.add_request(r)
    eng.run_until_drained()
    for r, ref in zip(reqs, refs):
        assert np.array_equal(np.array(r.output), ref), r.rid


def test_vision_tokens_depend_on_the_image(vision):
    cfg, model, prompts, ie, refs = vision
    p = prompts[3]
    a = tm.greedy_generate(cfg, model, p[None], [len(p)], MAX_NEW, ie[3:4])
    b = tm.greedy_generate(cfg, model, p[None], [len(p)], MAX_NEW, ie[:1])
    assert np.array_equal(a[0].numpy(), refs[3])
    assert not np.array_equal(a.numpy(), b.numpy())


def test_vision_prefill_without_an_image_is_refused(vision):
    cfg, model, prompts, _, _ = vision
    with pytest.raises(ValueError, match="image_embeds"):
        tm.prefill(cfg, model, tm.init_state(cfg, 1, 16, "cpu"),
                   prompts[0][None], [len(prompts[0])])


# ---------------------------------------------------------------------------
# payloads, transfer, abstract state
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", SERVED + ["llama_3_2_vision_11b"])
@pytest.mark.parametrize("length", [10, 129, 2000])
def test_payload_bytes_equal_reference(arch, length):
    """MLA's latent cache is trimmed to the rounded length; Mamba's states
    and the image keys / values cross whole."""
    jcfg = jget_config(arch, smoke=True)
    jst = jm.init_state(jcfg, 2, 2048)
    want = jserving.payload_bytes(jserving.extract(jcfg, jst, length,
                                                   slot=1))
    cfg = get_config(arch, smoke=True)
    st = tm.init_state(cfg, 2, 2048, "meta")
    assert payload_bytes(extract(cfg, st, length, slot=1)) == want


@pytest.mark.parametrize("arch,per_token,fixed", [
    # 27 layers x (512 + 64) x 2 B of latent cache
    ("deepseek_v2_lite_16b", 31_104, 0),
    # 64 layers x 2 x Hkv 8 x D 128 x 2 B
    ("qwen25_32b", 262_144, 0),
    # 32 self-attention layers x 2 x 8 x 128 x 2 B per token; 8 cross
    # layers x 2 x 6400 x 8 x 128 x 2 B of image keys / values
    ("llama_3_2_vision_11b", 131_072, 209_715_200),
    # 4 attention layers x 2 x 8 x 128 x 2 B per token; 28 Mamba layers x
    # (8192 x 16 x 4 B of ssm + 3 x 8192 x 2 B of conv)
    ("jamba_v0_1_52b", 16_384, 28 * (8192 * 16 * 4 + 3 * 8192 * 2))])
def test_full_width_payloads(arch, per_token, fixed):
    """Bytes per 128-rounded token and per request at the published
    widths (shapes only: the state lives on `meta`)."""
    cfg = get_config(arch)
    st = tm.init_state(cfg, 1, 2048, "meta")
    for L in (1, 64, 700, 2000):
        n = max(-(-L // 128) * 128, 8)
        assert payload_bytes(extract(cfg, st, L)) == per_token * n + fixed


@pytest.mark.parametrize("arch", ["deepseek_v2_lite_16b", "jamba_v0_1_52b"])
def test_transfer_equals_reference(arch):
    """kvtransfer.transfer: slot 1 of a prefilled pool into slot 2 of
    another, as the reference's transfer does it: the same destination
    state and the same ledger (transfers, bytes, tokens)."""
    cfg, model, jcfg, jparams = pair(arch)
    toks = np.random.RandomState(3).randint(
        0, cfg.vocab_size, (2, 12)).astype(np.int32)
    lens = np.array([5, 12], np.int32)
    jsrc = jm.prefill(jcfg, jparams, jm.init_state(jcfg, 2, 32),
                      jnp.asarray(toks), jnp.asarray(lens))[1]
    jstats = jserving.TransferStats()
    jdst = jserving.transfer(jcfg, jsrc, jm.init_state(jcfg, 3, 32), 12, 1,
                             2, jstats)
    src = tm.prefill(cfg, model, tm.init_state(cfg, 2, 32, "cpu"), toks,
                     lens)[1]
    stats = TransferStats()
    dst = transfer(cfg, src, tm.init_state(cfg, 3, 32, "cpu"), 12, 1, 2,
                   stats)
    assert (stats.n_transfers, stats.total_bytes, stats.total_tokens) == (
        jstats.n_transfers, jstats.total_bytes, jstats.total_tokens)
    for i, layer in enumerate(dst):
        if i < cfg.first_k_dense:
            want = jdst["prefix"][f"l{i}"]
        else:
            blk, j = divmod(i - cfg.first_k_dense, len(cfg.block_pattern))
            want = jax.tree.map(lambda a: a[blk], jdst["blocks"][f"p{j}"])
        for key, leaf in layer.items():
            np.testing.assert_allclose(leaf.numpy(), np.asarray(want[key]),
                                       atol=2e-4, rtol=2e-4)
        assert all(leaf[:2].eq(0).all() for leaf in layer.values())


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_abstract_state_matches_reference(arch):
    """Per layer (prefix first, then the stacked blocks unstacked), the
    same leaves with the same shapes and dtypes, on `meta`, full width."""
    cfg, jcfg = get_config(arch), jget_config(arch)
    st = tm.abstract_state(cfg, 3, 256)
    jst = jm.abstract_state(jcfg, 3, 256)
    want = [jst["prefix"][f"l{i}"] for i in range(cfg.first_k_dense)]
    for blk in range(cfg.num_blocks):
        for j in range(len(cfg.block_pattern)):
            want.append({k: (v.shape[1:], v.dtype) for k, v in
                         jst["blocks"][f"p{j}"].items()})
    assert len(st) == len(want) == cfg.num_layers
    for layer, w in zip(st, want):
        w = {k: v if isinstance(v, tuple) else (v.shape, v.dtype)
             for k, v in w.items()}
        assert set(layer) == set(w)
        for key, leaf in layer.items():
            assert leaf.device.type == "meta"
            assert tuple(leaf.shape) == tuple(w[key][0]), key
            assert str(leaf.dtype).split(".")[-1] == str(w[key][1]), key


def test_insert_keeps_the_image_and_the_mamba_state_whole():
    """extract -> insert into another slot: the image keys / values and
    the Mamba states land bit for bit; only the sequence leaves past the
    payload are zeroed."""
    for arch in ("llama_3_2_vision_11b", "jamba_v0_1_52b"):
        cfg, model, _, _ = pair(arch)
        p = np.arange(1, 14, dtype=np.int32)
        st = tm.init_state(cfg, 1, 64, "cpu")
        tm.prefill(cfg, model, st, p[None], [len(p)], images(cfg, 1))
        pool = tm.init_state(cfg, 3, 64, "cpu")
        insert(cfg, pool, extract(cfg, st, len(p)), 1)
        for one, layer in zip(st, pool):
            for key, leaf in layer.items():
                if key in ("k", "v"):
                    assert leaf[1, :13].equal(one[key][0, :13])
                else:
                    assert torch.equal(leaf[1], one[key][0]), key


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "kimi-k2-1t-a32b",
                                  "jamba-v0.1-52b"])
def test_serve_launcher_takes_the_zoo(arch, capsys):
    from repro_torch.launch import serve
    serve.main(["--arch", arch, "--device", "cpu", "--requests", "3",
                "--max-new", "4"])
    out = capsys.readouterr().out.strip().splitlines()[-1]
    assert '"completed": 3' in out and '"device": "cpu"' in out
