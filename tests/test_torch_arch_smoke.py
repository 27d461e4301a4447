"""Every architecture of the reference's registry in the port, as
tests/test_arch_smoke.py runs them there: each SMOKE config builds, and
one forward pass on the CPU gives logits of the expected shape, f32 and
finite, with a finite aux loss.  RWKV-6's prefill and a decode step
give finite logits too.  The full configs build on ``meta``.  No tolerance: shapes, dtypes and finiteness only (the parity
files hold the values).
"""
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS
from repro_torch import models as tm
from repro_torch.configs import ARCH_IDS as PORT_ARCH_IDS
from repro_torch.configs import get_config

B, S = 2, 16


def test_registry_equals_reference():
    assert PORT_ARCH_IDS == ARCH_IDS


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_forward_shapes_and_finite(arch):
    cfg = get_config(arch, smoke=True)
    assert cfg.num_layers <= 2 and cfg.d_model <= 512
    if cfg.moe:
        assert cfg.moe.num_experts <= 4
    full = tm.abstract_params(get_config(arch))
    assert full.embed.device.type == "meta"
    model = tm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = np.random.RandomState(1).randint(0, cfg.vocab_size, (B, S))
    ie = torch.randn(B, cfg.num_vision_tokens, cfg.d_model,
                     generator=torch.Generator().manual_seed(2)) \
        if cfg.num_vision_tokens else None
    if any(s.mixer == "rwkv" for s in cfg.layer_specs):
        st = tm.init_state(cfg, B, S + 1, "cpu")
        last, st = tm.prefill(cfg, model, st, toks, [S, S - 5], ie)
        step, _ = tm.decode_step(cfg, model, st, last.argmax(-1),
                                 [S, S - 5])
        assert last.shape == step.shape == (B, cfg.vocab_size)
        assert bool(torch.isfinite(step).all())
    logits, aux = tm.forward_train(cfg, model, toks, ie)
    assert logits.shape == (B, S, cfg.vocab_size)
    assert logits.dtype == torch.float32
    assert bool(torch.isfinite(logits).all())
    assert bool(torch.isfinite(aux))
