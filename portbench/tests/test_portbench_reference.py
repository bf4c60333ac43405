"""The plain reference against the port at small sizes on the CPU, both in
float32, so that only the order of summation separates them."""

from dataclasses import replace

import pytest
import torch

from conftest import tiny_cell
from portbench import port, seeded
from portbench.reference import lm as ref


def port_f32(conf, name):
    cfg = port.model_config(conf, name)
    return replace(cfg, param_dtype="float32", compute_dtype="float32")


@pytest.mark.parametrize("cell_name", ["phi3-vision-4b.prefill-2k",
                                       "phi3-vision-4b.prefill-16k"])
def test_prefill_logits_and_cache_match_the_port(bench, cell_name):
    from repro_torch.models import lm
    cell, conf, t = tiny_cell(bench, cell_name)
    cfg = port_f32(conf, cell.config)
    flat = seeded.weights(conf, 7, "cpu", torch.float32)
    model = port.lm(cfg, flat, conf)
    b, n = t["batch"], t["prompt_tokens"]
    tokens = seeded.prompt_pool(7, b, n, conf["vocab_size"])
    patches = seeded.patch_pool(7, b, conf["n_patches"], conf["hidden_size"],
                                "cpu", torch.float32)
    cache = lm.init_cache(cfg, b, n + conf["n_patches"] + 8, "cpu")
    logits, _ = lm.prefill(model, cfg, tokens, cache, patches=patches,
                           impl="flash_pallas")
    seen = {}
    want = ref.prefill(flat, conf, tokens, patches, ref.Precision(),
                       kv=lambda i, k, v: seen.update({i: (k, v)}))
    torch.testing.assert_close(logits[:, -1], want, rtol=1e-4,
                               atol=1e-4)
    s = n + conf["n_patches"]
    for i, c in enumerate(cache):
        torch.testing.assert_close(c["k"][:, :s], seen[i][0], rtol=1e-4,
                                   atol=1e-4)
        torch.testing.assert_close(c["v"][:, :s], seen[i][1], rtol=1e-4,
                                   atol=1e-4)


def test_training_steps_match_the_port(bench):
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import AdamWConfig, adamw_init
    cell, conf, t = tiny_cell(bench, "olmo-1b.train-4k")
    cfg = port_f32(conf, cell.config)
    flat = seeded.weights(conf, 3, "cpu", torch.float32)
    start = {k: v.clone() for k, v in flat.items()}
    model = port.lm(cfg, flat, conf)
    state = adamw_init(dict(model.named_parameters()))
    step = make_train_step(cfg, AdamWConfig(**t["optimizer"]), remat=True)
    batches = [seeded.train_batch(3, k, t["batch"], t["seq_len"],
                                  conf["vocab_size"], "cpu")
               for k in range(3)]
    losses = []
    for k, batch in enumerate(batches):
        model, state, metrics = step(model, state, batch)
        losses.append(float(metrics["loss"]))
        if k == 0:
            gnorm = float(metrics["grad_norm"])
            grads = {n: float(m.norm()) / (1 - t["optimizer"]["b1"])
                     for n, m in state["m"].items()}
    want = ref.train(start, conf, batches, t["optimizer"], ref.Precision())
    assert losses == pytest.approx(want["loss"], rel=1e-5)
    assert gnorm == pytest.approx(want["gnorm"], rel=1e-4)
    for n, g in want["grad_norms"].items():
        assert grads[n] == pytest.approx(g, rel=1e-4, abs=1e-9), n
    for n, p in model.named_parameters():
        change = float((p.detach() - start[n]).norm())
        assert change == pytest.approx(want["change_norms"][n], rel=1e-3,
                                       abs=1e-9), n


def test_fp8_control_rounds_each_operand():
    a = torch.linspace(-3, 3, 64).reshape(8, 8)
    b = torch.eye(8)
    out = ref.Precision("fp8").mm(a, b)
    assert not torch.equal(out, a)
    assert (out - a).abs().max() <= 3 * 2 ** -4
    g = torch.randn(8, 8, requires_grad=True)
    ref.Precision("fp8").mm(g, b).sum().backward()
    assert g.grad is not None and g.grad.shape == (8, 8)
