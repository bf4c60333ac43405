"""The sharded train step on values, on four ranks.

The dry run's ranks hold ``meta`` shards, and the card's mesh is (1, 1),
where every placement is a replica; neither runs the sharded arithmetic
on values.  Here four processes are the ranks of a (2, 2) ``("data",
"model")`` mesh over a gloo process group on ``localhost``, each holding
its own float32 shards on the CPU.  At smoke size, with two microbatches of
four rows (the batch split over ``data``, the sequence and the heads
over ``model``), each arch's sharded loss, every parameter's gradient and
the parameters after one AdamW step (``make_train_step``) equal the plain
step's from the same weights and batch within ``RTOL``/``ATOL``
(float32: the sharded sums add in another order), and so do the AdamW
moments:

* olmo-1b: the dense path;
* minicpm3-4b with 3 heads: MLA, heads that do not divide the TP axis
  (zero-padded to 4 in attention, whole-head reshapes);
* jamba-v0.1-52b: the chunked scan's recurrence on each rank's shards
  (``local_map``), MoE;
* whisper-small: the encoder-decoder, the vocabulary-parallel
  cross-entropy and the tied embedding's gradient.
"""

from dataclasses import replace

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch import pspec
from repro_torch.configs import get_smoke_config
from repro_torch.launch.sharding import (distribute, distribute_params,
                                         input_specs_sharding)
from repro_torch.launch.steps import (init_train_state, make_loss_fn,
                                      make_train_step)
from repro_torch.optim import AdamWConfig, adamw_init

ARCHS = ("olmo_1b", "minicpm3_4b", "jamba_v01_52b", "whisper_small")
MESH = {"data": 2, "model": 2}
B, S = 8, 16
RTOL, ATOL = 1e-5, 1e-6
# AdamW's first step moves a weight by lr·g/(|g| + eps): at the default
# eps (1e-8) a gradient near eps turns a float32 rounding of g into a
# move of up to lr; at 1e-4 a move differs by at most lr·|δg|/eps
OPT = AdamWConfig(eps=1e-4)


def _cfg(arch):
    cfg = replace(get_smoke_config(arch), compute_dtype="float32",
                  train_microbatches=2)
    if arch == "minicpm3_4b":
        cfg = replace(cfg, attention=replace(cfg.attention, n_heads=3,
                                             n_kv_heads=3))
    return cfg


def _batch(cfg):
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S + 1)))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.enc_dec is not None:
        batch["frames"] = torch.from_numpy(rng.standard_normal(
            (B, cfg.enc_dec.encoder_len, cfg.d_model)).astype(np.float32))
    return batch


def _weights(cfg):
    return init_train_state(cfg, torch.Generator().manual_seed(0), "cpu")[0]


def _plain(cfg, batch):
    model = _weights(cfg)
    params = dict(model.named_parameters())
    loss, _ = make_loss_fn(cfg)(model, batch)
    grads = dict(zip(params, torch.autograd.grad(loss, list(
        params.values()))))
    _, state, metrics = make_train_step(cfg, OPT)(model, adamw_init(params),
                                                  batch)
    return loss.detach(), grads, metrics, state, model


def _sharded(mesh, cfg, batch):
    """This rank's loss, gradients and stepped parameters, each gathered
    whole (every rank takes part in every gather)."""
    module = distribute_params(_weights(cfg), mesh)
    placed = input_specs_sharding(mesh, batch)
    sharded = {k: distribute(v, mesh, placed[k]) for k, v in batch.items()}
    params = dict(module.named_parameters())
    loss, _ = make_loss_fn(cfg)(module, sharded)
    grads = torch.autograd.grad(loss, list(params.values()))
    out = {"loss": loss.full_tensor(),
           "grads": {n: g.full_tensor() for n, g in zip(params, grads)}}
    _, state, metrics = make_train_step(cfg, OPT)(
        module, adamw_init(params), sharded)
    whole = lambda t: t.full_tensor() if pspec.is_dtensor(t) else t  # noqa
    out["metrics"] = {k: whole(v) for k, v in metrics.items()}
    out["moments"] = {k: {n: whole(t) for n, t in state[k].items()}
                      for k in ("m", "v")}
    out["params"] = {n: p.full_tensor() for n, p in
                     module.named_parameters()}
    return out


def _rank(rank, world, port, path):
    """One rank's process: every arch's sharded step; rank 0 saves them."""
    from torch.distributed.device_mesh import init_device_mesh
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    try:
        mesh = init_device_mesh("cpu", tuple(MESH.values()),
                                mesh_dim_names=tuple(MESH))
        with pspec.activation_mesh(mesh):
            out = {arch: _sharded(mesh, _cfg(arch), _batch(_cfg(arch)))
                   for arch in ARCHS}
        if rank == 0:
            torch.save(out, path)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """Every arch's sharded results, from one run of four rank processes
    (gloo, ``localhost``)."""
    import socket
    import torch.multiprocessing as mp
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    path = tmp_path_factory.mktemp("ranks") / "sharded.pt"
    world = 1
    for n in MESH.values():
        world *= n
    mp.spawn(_rank, args=(world, port, str(path)), nprocs=world, join=True)
    return torch.load(path)


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_step_on_four_ranks_matches_plain(arch, sharded):
    cfg = _cfg(arch)
    loss, grads, metrics, state, stepped = _plain(cfg, _batch(cfg))
    got = sharded[arch]
    close = dict(rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(got["loss"], loss, **close)
    assert grads.keys() == got["grads"].keys()
    for name, g in grads.items():
        torch.testing.assert_close(got["grads"][name], g, **close,
                                   msg=lambda m, n=name: f"{n}: {m}")
    for key in ("loss", "grad_norm"):
        torch.testing.assert_close(got["metrics"][key], metrics[key],
                                   **close,
                                   msg=lambda m, n=key: f"{n}: {m}")
    # the moments as the gradients they hold (m = (1 - b1)·g, v = (1 - b2)·g²
    # after one step), held at the gradients' limits
    as_grad = {"m": lambda t: t / (1 - OPT.b1),
               "v": lambda t: torch.sqrt(t / (1 - OPT.b2))}
    for k, f in as_grad.items():
        for name, t in state[k].items():
            torch.testing.assert_close(
                f(got["moments"][k][name]), f(t), **close,
                msg=lambda m, n=f"{k}[{name}]": f"{n}: {m}")
    for name, p in stepped.named_parameters():
        torch.testing.assert_close(got["params"][name], p.detach(),
                                   **close,
                                   msg=lambda m, n=name: f"{n}: {m}")
