"""A run with the timed path broken underneath comes out not correct.

Each test skips the harness's look for a card and drives the rest of a
run on the CPU at a tiny cell's size, with one fault planted in the
program where its result is produced: a token altered where the sampler
picks it; a decode step that returns its state unchanged (no K/V written,
the position not advanced); half of the batch left out of the prefill
(its rows given the other half's prompts).  In the MoE layer, where the
router's choice is made: the first expert alone in place of the top two;
the top two's gates not renormalised; every chosen expert's index shifted
by one.  A one-card cell has no exchange between chips to leave out.
Unbroken, the same run is correct.  On the card (`gpu`) the MoE faults
are planted in a run of the Mixtral cell at its own size."""

import pytest
import torch

from bench import harness
from bench.result import result_line
from bench.spec import load_cell
from bench.tests import tiny

SEED = 424242424242


@pytest.fixture(autouse=True)
def no_warm_up(monkeypatch):
    """Serve no warm-up before the window: its host state is the card's."""
    monkeypatch.setattr(harness, "WARM_SECONDS", 0.0)


@pytest.fixture
def fresh_api():
    from repro_torch.models import registry

    registry.get_api.cache_clear()
    yield
    registry.get_api.cache_clear()


def run_tiny(config):
    cell = tiny.cell(config, sample=12)
    run, device, found = harness.run_cell(cell, SEED, 0.0, False, device="cpu", energy=False)
    return run, result_line(cell, run, device, found, False)


def altered_token(monkeypatch):
    from repro_torch.serving.sampler import Sampler

    def call(self, logits, generator):
        return ((torch.argmax(logits, dim=-1) + 1) % logits.shape[-1]).to(torch.int32)

    monkeypatch.setattr(Sampler, "__call__", call)


def state_unchanged(monkeypatch):
    from repro_torch.models import cache, dense, moe

    monkeypatch.setattr(cache, "write_token", lambda cache_l, new, slot: None)
    for mod in (dense, moe):
        step = mod.decode_step

        def stuck(cfg, params, c, batch, step=step):
            logits, _ = step(cfg, params, c, batch)
            return logits, type(c)(c.k, c.v, c.pos)

        monkeypatch.setattr(mod, "decode_step", stuck)


def half_batch(monkeypatch):
    from repro_torch.models import dense, moe

    for mod in (dense, moe):
        prefill = mod.prefill

        def half(cfg, params, batch, *, prefill=prefill, **kw):
            toks = batch["tokens"].clone()
            h = toks.shape[0] // 2
            toks[h:2 * h] = toks[:h]
            return prefill(cfg, params, {**batch, "tokens": toks}, **kw)

        monkeypatch.setattr(mod, "prefill", half)


def _rerouted(monkeypatch, change):
    """`moe.route` with `change(cfg, probs, gates, eidx) -> (gates, eidx)`."""
    from repro_torch.models import moe

    route = moe.route

    def broken(cfg, router, xt):
        probs, gates, eidx = route(cfg, router, xt)
        return (probs, *change(cfg, probs, gates, eidx))

    monkeypatch.setattr(moe, "route", broken)


def top_one(monkeypatch):
    _rerouted(monkeypatch, lambda cfg, p, g, e: (
        torch.cat([torch.ones_like(g[:, :1]), torch.zeros_like(g[:, 1:])], dim=1), e))


def gates_not_renormalised(monkeypatch):
    _rerouted(monkeypatch, lambda cfg, p, g, e: (p.gather(1, e), e))


def experts_shifted(monkeypatch):
    _rerouted(monkeypatch, lambda cfg, p, g, e: (g, (e + 1) % cfg.n_experts))


MOE_FAULTS = [top_one, gates_not_renormalised, experts_shifted]


@pytest.mark.parametrize("config", [tiny.DENSE, tiny.MOE], ids=["dense", "moe"])
def test_unbroken_run_is_correct(config, fresh_api):
    _, out = run_tiny(config)
    assert out["correct"] is True


@pytest.mark.parametrize("fault", [altered_token, state_unchanged, half_batch])
@pytest.mark.parametrize("config", [tiny.DENSE, tiny.MOE], ids=["dense", "moe"])
def test_broken_run_is_not_correct(config, fault, monkeypatch, fresh_api):
    fault(monkeypatch)
    run, out = run_tiny(config)
    if fault is half_batch:      # the sample holds a request the fault reaches
        assert any(row >= s.batch.tokens.shape[0] // 2 for s, row, _ in run.requests())
    assert out["correct"] is False, out["check"]


@pytest.mark.parametrize("fault", MOE_FAULTS)
def test_broken_moe_layer_is_not_correct(fault, monkeypatch, fresh_api):
    fault(monkeypatch)
    _, out = run_tiny(tiny.MOE)
    assert out["correct"] is False, out["check"]


@pytest.mark.gpu
@pytest.mark.parametrize("fault", MOE_FAULTS)
def test_broken_moe_layer_is_not_correct_at_the_cells_size(card, fault, monkeypatch, fresh_api):
    import gc

    from bench.result import correct

    fault(monkeypatch)
    cell = load_cell("mixtral-8x7b.chat")
    run, _, found = harness.run_cell(cell, SEED, 0.0, False, device=card, energy=False)
    print(fault.__name__, found)
    assert not correct(cell, found), found
    del run
    gc.collect()
    torch.cuda.empty_cache()
