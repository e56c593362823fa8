"""Rank programs of the port's distributed CPU tests.

Each ``*_world`` function runs on every rank of a world that
``paddle_tpu_torch.distributed.spawn`` starts (gloo on the CPU) and
returns ``{case: numpy result or {"error": traceback}}``; the test files
hold each case against the JAX package's stacked result for this rank's
slot.  This module imports torch and the port only, so a rank starts in
a few seconds.
"""
import traceback
import warnings

import numpy as np
import torch

import paddle_tpu_torch as tpt
import paddle_tpu_torch.distributed as dist
from paddle_tpu_torch import nn
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.distributed import fleet
from paddle_tpu_torch.distributed.mesh import build_mesh, set_mesh


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy() if x.dtype == torch.bfloat16 \
            else x.detach().numpy()
    if isinstance(x, (list, tuple)):
        return type(x)(_np(v) for v in x)
    if isinstance(x, dict):
        return {k: _np(v) for k, v in x.items()}
    return x


def _run(cases):
    out = {}
    for name, fn in cases:
        try:
            out[name] = _np(fn())
        except Exception:  # reported per case by the test
            out[name] = {"error": traceback.format_exc()}
    return out


def _reset_fleet():
    fleet._initialized = False
    fleet._strategy = None
    set_mesh(build_mesh())


# -- collectives ---------------------------------------------------------------
def collectives_world(inputs):
    """``inputs``: stacked numpy arrays ``[n, ...]``; rank i uses slot i."""
    tpt.set_device("cpu")
    r = dist.get_rank()
    n = dist.get_world_size()
    set_mesh(build_mesh())
    x = {k: torch.from_numpy(np.ascontiguousarray(v[r]))
         for k, v in inputs.items() if v.shape[0] == n}
    t = lambda k: x[k].clone()  # noqa: E731

    def hybrid(axis):
        # dp 2 x mp 2: rank (d, m) holds the "model"-stacked slot m
        mesh = set_mesh(build_mesh(dp=2, mp=2))
        slot = mesh.axis_index(axis)
        v = torch.tensor(inputs["pair"][slot])
        out = dist.all_reduce(v, group=axis)
        set_mesh(build_mesh())
        return out

    def stats():
        dist.reset_collective_stats()
        dist.all_reduce(t("a"))
        dist.all_gather(t("a"))
        return {k: [v["calls"], v["staged_bytes"]]
                for k, v in dist.collective_stats().items()}

    def start_finish():
        h = dist.collective.all_reduce_start(t("a"), "data")
        return dist.collective.all_reduce_finish(h)

    def grad_psum():
        a = t("a").requires_grad_(True)
        (dist.psum(a, "data") * t("b")).sum().backward()
        return a.grad

    def grad_a2a():
        a = t("c").requires_grad_(True)
        out = dist.all_to_all_single(a, "data", split_axis=0, concat_axis=1)
        (out * torch.arange(out.numel()).reshape(out.shape)).sum().backward()
        return a.grad

    cases = [
        ("all_reduce_sum", lambda: dist.all_reduce(t("a"))),
        ("all_reduce_max", lambda: dist.all_reduce(t("a"), op="max")),
        ("all_reduce_min", lambda: dist.all_reduce(t("a"), op="min")),
        ("all_reduce_prod", lambda: dist.all_reduce(t("a"), op="prod")),
        ("all_gather", lambda: np.stack(_np(dist.all_gather(t("a"))))),
        ("all_gather_into_list", lambda: (lambda lst: (
            dist.all_gather(lst, t("a")), np.stack(_np(lst)))[1])([])),
        ("reduce", lambda: dist.reduce(t("a"), dst=1)),
        ("broadcast", lambda: dist.broadcast(t("a"), src=2)),
        ("scatter", lambda: dist.scatter(
            torch.zeros_like(x["a"]),
            [torch.from_numpy(np.ascontiguousarray(v))
             for v in inputs["a"]] if r == 0 else None, src=0)),
        ("alltoall", lambda: np.stack(_np(dist.alltoall(
            list(torch.from_numpy(np.ascontiguousarray(x["m"].numpy()))))))),
        ("barrier", lambda: (dist.barrier(), 0)[1]),
        ("psum", lambda: dist.psum(t("a"), "data")),
        ("pmean", lambda: dist.pmean(t("a"), "data")),
        ("pmax", lambda: dist.pmax(t("a"), "data")),
        ("pmin", lambda: dist.pmin(t("a"), "data")),
        ("ppermute_ring", lambda: dist.ppermute(
            t("a"), "data", [(j, (j + 1) % n) for j in range(n)])),
        ("ppermute_partial", lambda: dist.ppermute(
            t("a"), "data", [(0, 2), (2, 1)])),
        ("all_to_all_0_1", lambda: dist.all_to_all_single(
            t("c"), "data", split_axis=0, concat_axis=1)),
        ("all_to_all_1_0", lambda: dist.all_to_all_single(
            t("c"), "data", split_axis=1, concat_axis=0)),
        ("group_model", lambda: hybrid("model")),
        ("group_data", lambda: hybrid("data")),
        ("bf16_all_reduce", lambda: dist.all_reduce(
            t("a").to(torch.bfloat16))),
        ("start_finish", start_finish),
        ("grad_psum", grad_psum),
        ("grad_all_to_all", grad_a2a),
        ("stats", stats),
        ("env", lambda: [dist.ParallelEnv().rank,
                         dist.ParallelEnv().world_size,
                         dist.get_rank(), dist.get_world_size(),
                         int(dist.is_initialized())]),
    ]
    return _run(cases)


def hang_world(mode):
    """A world that fails on purpose: rank 1 raises or sleeps."""
    import time

    if dist.get_rank() == 1:
        if mode == "raise":
            raise RuntimeError("rank 1 fails on purpose")
        time.sleep(3600)
    tpt.set_device("cpu")
    set_mesh(build_mesh())
    dist.barrier()  # rank 0 waits here for the dead or stuck rank
    return 0


# -- training ------------------------------------------------------------------
class MLP(nn.Layer):
    def __init__(self, d=16, classes=4, hidden=32):
        super().__init__()
        self.fc1 = nn.Linear(d, hidden)
        self.act = nn.ReLU()
        self.fc2 = nn.Linear(hidden, classes)

    def forward(self, x):
        return self.fc2(self.act(self.fc1(x)))


class TPMLP(nn.Layer):
    def __init__(self):
        super().__init__()
        mp = dist.meta_parallel
        self.fc1 = mp.ColumnParallelLinear(16, 32, gather_output=False)
        self.act = nn.ReLU()
        self.fc2 = mp.RowParallelLinear(32, 4, input_is_parallel=True)

    def forward(self, x):
        return self.fc2(self.act(self.fc1(x)))


def _load(net, params):
    with torch.no_grad():
        for k, p in net.named_parameters():
            p.copy_(torch.from_numpy(np.ascontiguousarray(params[k])))
    return net


def _fit(net, params, data, strategy, opt, epochs, batch_size=64):
    from paddle_tpu_torch import io as tio
    from paddle_tpu_torch import metric as tmetric

    _load(net, params)
    X, y = data
    if strategy is not None:
        fleet.init(is_collective=True, strategy=strategy)
        opt = fleet.distributed_optimizer(opt)
    model = tpt.Model(net)
    model.prepare(optimizer=opt, loss=nn.CrossEntropyLoss(),
                  metrics=[tmetric.Accuracy()])
    ds = tio.TensorDataset([X, y.reshape(-1, 1)])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        model.fit(ds, batch_size=batch_size, epochs=epochs, verbose=0,
                  shuffle=False)
        logs = model.evaluate(ds, batch_size=batch_size, verbose=0)
    return model, logs


def _gathered(model):
    plan = model._plan
    if plan is None:
        return {k: p.detach() for k, p in model.network.named_parameters()}
    return plan.gather_parameters()


def training_world(inp):
    """The training cases; ``inp`` holds the seeded data and inits."""
    tpt.set_device("cpu")
    r = dist.get_rank()
    n = dist.get_world_size()
    set_mesh(build_mesh())
    data = (inp["X"], inp["y"])

    def requires_init():
        _reset_fleet()
        try:
            fleet.distributed_optimizer(topt.SGD(),
                                        strategy=fleet.DistributedStrategy(
                                            sharding=True))
        except Exception as e:  # noqa: BLE001
            return [type(e).__name__, str(e), fleet.get_strategy() is None]
        return ["no error"]

    def ps_rejected():
        try:
            fleet.init(is_collective=False)
        except Exception as e:  # noqa: BLE001
            return [type(e).__name__, str(e)]
        return ["no error"]

    def worker_info():
        _reset_fleet()
        fleet.init(is_collective=True)
        fleet.barrier_worker()
        return [fleet.worker_num(), fleet.worker_index(),
                int(fleet.is_first_worker())]

    def dp():
        _reset_fleet()
        model, logs = _fit(MLP(), inp["mlp"], data,
                           fleet.DistributedStrategy(),
                           topt.Momentum(learning_rate=0.05), epochs=2)
        return {"loss": logs["loss"], "acc": logs["acc"],
                "params": _gathered(model)}

    def zero():
        _reset_fleet()
        model, logs = _fit(MLP(), inp["mlp"], data,
                           fleet.DistributedStrategy(sharding=True),
                           topt.Momentum(learning_rate=0.05), epochs=2)
        slots = model._optimizer._state["slots"]
        return {"loss": logs["loss"], "acc": logs["acc"],
                "params": _gathered(model),
                "mesh": dict(dist.get_mesh().shape),
                "slot_shapes": {k: list(v["velocity"].shape)
                                for k, v in slots.items()},
                "param_shapes": {k: list(p.shape) for k, p in
                                 model.network.named_parameters()}}

    def tp():
        _reset_fleet()
        strat = fleet.DistributedStrategy(
            tensor_parallel=True,
            tensor_parallel_configs={"tensor_parallel_degree": 2})
        fleet.init(is_collective=True, strategy=strat)
        net = _load(TPMLP(), inp["mlp"])
        opt = fleet.distributed_optimizer(topt.Adam(learning_rate=5e-3))
        model = tpt.Model(net)
        model.prepare(optimizer=opt, loss=nn.CrossEntropyLoss())
        X, y = data
        losses = [model.train_batch([X[i * 64:(i + 1) * 64]],
                                    [y[i * 64:(i + 1) * 64, None]])[0]
                  for i in range(4)]
        params = _gathered(model)
        shapes = {k: list(p.shape) for k, p in net.named_parameters()}
        # a second prepare keeps every rank's shard
        model.prepare(optimizer=fleet.distributed_optimizer(
            topt.Adam(learning_rate=5e-3)), loss=nn.CrossEntropyLoss())
        again = _gathered(model)
        return {"losses": np.asarray(losses), "params": params,
                "local_shapes": shapes,
                "reprepared_same": all(torch.equal(params[k], again[k])
                                       for k in params)}

    def col_row():
        _reset_fleet()
        fleet.init(is_collective=True, strategy=fleet.DistributedStrategy(
            mp_degree=2))
        net = _load(TPMLP(), inp["mlp"])
        fleet.distributed_model(net)
        xx = torch.from_numpy(inp["x4"]).requires_grad_(True)
        out = net.fc2(net.fc1(xx))
        (out * torch.from_numpy(inp["w4"])).sum().backward()
        grads = {k: p.grad.clone() for k, p in net.named_parameters()}
        dx = xx.grad.clone()
        # the defer_row_reduce dial: the bias joins rank 0's partial sum
        # and the reduce comes last — the same values
        for p in list(net.parameters()) + [xx]:
            p.grad = None
        with dist.collective.overlap_schedule(defer_row_reduce=1):
            deferred = net.fc2(net.fc1(xx))
        (deferred * torch.from_numpy(inp["w4"])).sum().backward()
        return {"out": out, "dx": dx, "grads": grads,
                "deferred_out": deferred,
                "deferred_grads": {k: p.grad for k, p in
                                   net.named_parameters()}}

    def vocab():
        _reset_fleet()
        fleet.init(is_collective=True, strategy=fleet.DistributedStrategy(
            mp_degree=2))
        emb = dist.meta_parallel.VocabParallelEmbedding(64, 16)
        _load(emb, {"weight": inp["emb"]})
        fleet.distributed_model(emb)
        ids = torch.tensor([[1, 5], [63, 0], [32, 31]])
        out = emb(ids)
        out.sum().backward()
        return {"out": out, "rows": list(emb.weight.shape),
                "grad": emb.weight.grad}

    def gpt_hybrid():
        _reset_fleet()
        from paddle_tpu_torch.bridge import load_jax_params
        from paddle_tpu_torch.models import gpt as tgpt

        fleet.init(is_collective=True, strategy=fleet.DistributedStrategy(
            sharding_degree=2, mp_degree=2))
        net = tgpt.GPTForCausalLM(tgpt.gpt_tiny(), device="cpu")
        load_jax_params(net, inp["gpt"])
        opt = fleet.distributed_optimizer(topt.AdamW(
            learning_rate=1e-3, weight_decay=0.01))
        model = tpt.Model(net)
        model.prepare(optimizer=opt, loss=net.loss)
        losses = [model.train_batch([ids], [ids])[0]
                  for ids in inp["gpt_batches"]]
        slots = model._optimizer._state["slots"]
        return {"losses": np.asarray(losses),
                "params": _gathered(model),
                "qkv_local": list(net.gpt.blocks[0].attn.qkv.weight.shape),
                "wte_local": list(net.gpt.wte.weight.shape),
                "slot_qkv": list(slots["gpt.blocks.0.attn.qkv.weight"]
                                 ["moment1"].shape)}

    def regressions():
        _reset_fleet()
        from paddle_tpu_torch import io as tio
        from paddle_tpu_torch import metric as tmetric

        out = {}
        fleet.init(is_collective=True, strategy=fleet.DistributedStrategy())
        X, y = data
        model = tpt.Model(_load(MLP(), inp["mlp"]))
        model.prepare(optimizer=fleet.distributed_optimizer(
            topt.SGD(learning_rate=0.01)), loss=nn.CrossEntropyLoss(),
            metrics=[tmetric.Accuracy()])
        ds100 = tio.TensorDataset([X[:100], y[:100].reshape(-1, 1)])
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            model.fit(ds100, batch_size=64, epochs=1, verbose=0,
                      shuffle=False)
        out["partial_dropped_warns"] = int(any(
            "partial batch" in str(m.message) for m in w))
        try:
            model._plan.shard_batch((np.zeros((6, 16), np.float32),))
            out["indivisible"] = "no error"
        except Exception as e:  # noqa: BLE001
            out["indivisible"] = str(e)
        logs = model.evaluate(tio.TensorDataset(
            [X[:128], y[:128].reshape(-1, 1)]), batch_size=64, verbose=0)
        out["eval_keys"] = sorted(logs)
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            model.evaluate(tio.TensorDataset(
                [X[:16], y[:16].reshape(-1, 1)]), batch_size=64, verbose=0)
        out["zero_batches_warns"] = int(any(
            "zero batches" in str(m.message) for m in w))
        pred = model.predict(tio.TensorDataset([X[:100]]), batch_size=64,
                             stack_outputs=True)
        out["predict_rows"] = int(np.asarray(pred).shape[0])
        out["predict"] = np.asarray(pred)
        try:
            model.prepare(optimizer=fleet.distributed_optimizer(
                topt.SGD(learning_rate=0.01)), loss=nn.CrossEntropyLoss(),
                steps_per_execution=2)
            out["spe"] = "no error"
        except Exception as e:  # noqa: BLE001
            out["spe"] = [type(e).__name__, str(e)]
        _reset_fleet()
        mesh = fleet.init(is_collective=True,
                          strategy=fleet.DistributedStrategy(
                              dp_degree=2, sharding=True))
        out["dp_sharding_mesh"] = [mesh.shape["data"], mesh.shape["sharding"]]
        _reset_fleet()
        try:
            fleet.init(is_collective=True, strategy=fleet.DistributedStrategy(
                sharding=True, mp_degree=16))
            out["oversubscribed"] = "no error"
        except Exception as e:  # noqa: BLE001
            out["oversubscribed"] = str(e)
        unported = {}
        for flag in ("localsgd", "dgc", "fp16_allreduce"):
            _reset_fleet()
            fleet.init(is_collective=True)
            try:
                fleet.distributed_optimizer(
                    topt.Momentum(learning_rate=0.1),
                    strategy=fleet.DistributedStrategy(**{flag: True}))
                unported[flag] = "no error"
            except Exception as e:  # noqa: BLE001
                unported[flag] = [type(e).__name__, str(e)]
        for kw in ({"pp_degree": 2}, {"ep_degree": 2}):
            _reset_fleet()
            try:
                fleet.init(is_collective=True,
                           strategy=fleet.DistributedStrategy(**kw))
                unported[str(kw)] = "no error"
            except Exception as e:  # noqa: BLE001
                unported[str(kw)] = [type(e).__name__, str(e)]
        # single-model-rank legs: a LoRA table at mp 2, Lamb on shards
        _reset_fleet()
        fleet.init(is_collective=True,
                   strategy=fleet.DistributedStrategy(mp_degree=2))
        lora = TPMLP()
        lora.fc1.register_buffer("lora_A", torch.zeros(1, 16, 2))
        lamb = tpt.Model(TPMLP())
        for what, call in (
                ("lora_mp2", lambda: fleet.distributed_model(lora)),
                ("lamb_mp2", lambda: lamb.prepare(
                    optimizer=fleet.distributed_optimizer(topt.Lamb()),
                    loss=nn.CrossEntropyLoss()))):
            try:
                call()
                unported[what] = "no error"
            except Exception as e:  # noqa: BLE001
                unported[what] = [type(e).__name__, str(e)]
        out["unported"] = unported
        return out

    def sync_bn():
        _reset_fleet()
        set_mesh(build_mesh())
        xs = inp["bn_x"]
        rows = xs.shape[0] // n
        xl = torch.from_numpy(np.ascontiguousarray(
            xs[r * rows:(r + 1) * rows])).requires_grad_(True)
        tpt.seed(0)
        sbn = nn.SyncBatchNorm(3)
        bn = nn.BatchNorm2D(3)
        y = sbn(xl)
        (y * torch.from_numpy(inp["bn_w"][r * rows:(r + 1) * rows])
         ).sum().backward()
        local = bn(xl.detach())
        # through the fleet plan: SGD(lr 0), a zero loss
        fleet.init(is_collective=True, strategy=fleet.DistributedStrategy())
        net = nn.SyncBatchNorm(3)
        model = tpt.Model(net, inputs=["x"], labels=["y"])
        model.prepare(optimizer=fleet.distributed_optimizer(
            topt.SGD(learning_rate=0.0)),
            loss=lambda out, yy: out.mean() * 0.0)
        model.train_batch([xs], [np.zeros((xs.shape[0], 1), np.float32)])
        return {"y": y, "dx": xl.grad, "local": local,
                "running_mean": sbn._mean, "running_var": sbn._variance,
                "plan_mean": net._mean}

    def data_parallel():
        _reset_fleet()
        set_mesh(build_mesh())
        net = dist.DataParallel(_load(MLP(), inp["mlp"]))
        X, y = data
        rows = 64 // n
        xb = torch.from_numpy(X[r * rows:(r + 1) * rows])
        yb = torch.from_numpy(y[r * rows:(r + 1) * rows])
        loss = torch.nn.functional.cross_entropy(net(xb), yb)
        net.scale_loss(loss).backward()
        net.apply_collective_grads()
        return {k: p.grad for k, p in net._layers.named_parameters()}

    def sampler():
        # num_replicas / rank default from the joined world
        from paddle_tpu_torch import io as tio

        s = tio.DistributedBatchSampler(
            tio.TensorDataset([inp["X"][:23]]), 4, shuffle=True)
        s.set_epoch(1)
        return [s.num_replicas, s.rank, list(s)]

    def recompute():
        # strategy.recompute wraps the blocks; the steps are the plain ones
        from paddle_tpu_torch.bridge import load_jax_params
        from paddle_tpu_torch.models import gpt as tgpt

        out = {}
        for on in (False, True):
            _reset_fleet()
            fleet.init(is_collective=True,
                       strategy=fleet.DistributedStrategy(recompute=on))
            net = tgpt.GPTForCausalLM(tgpt.gpt_tiny(), device="cpu")
            load_jax_params(net, inp["gpt"])
            model = tpt.Model(net)
            model.prepare(optimizer=fleet.distributed_optimizer(
                topt.AdamW(learning_rate=1e-3)), loss=net.loss)
            out[on] = [model.train_batch([ids], [ids])[0]
                       for ids in inp["gpt_batches"]]
            out[f"wrapped_{on}"] = sum(
                bool(getattr(m, "_recompute_wrapped", False))
                for m in net.modules())
        return {"plain": out[False], "recompute": out[True],
                "wrapped": [out["wrapped_False"], out["wrapped_True"]]}

    cases = [("requires_init", requires_init), ("ps_rejected", ps_rejected),
             ("worker_info", worker_info), ("dp", dp), ("zero", zero),
             ("sampler", sampler), ("recompute", recompute)]
    if n == 4:
        cases += [("tp", tp), ("col_row", col_row), ("vocab", vocab),
                  ("gpt_hybrid", gpt_hybrid), ("regressions", regressions),
                  ("sync_bn", sync_bn), ("data_parallel", data_parallel)]
    return _run(cases)


# -- sequence parallel -----------------------------------------------------------
def sequence_world(inp):
    tpt.set_device("cpu")
    r = dist.get_rank()
    set_mesh(build_mesh(sep=dist.get_world_size()))
    sp = dist.sequence_parallel

    def attn(fn, causal):
        q, k, v = (torch.from_numpy(inp[n]).requires_grad_(True)
                   for n in "qkv")
        out = fn(q, k, v, axis="sep", causal=causal)
        (out * torch.from_numpy(inp["do"])).sum().backward()
        return {"out": out, "dq": q.grad, "dk": k.grad, "dv": v.grad}

    def local_ring():
        # the in-shard_map form: this rank's chunks in, its chunk out
        S = inp["q"].shape[2] // dist.get_world_size()
        q, k, v = (torch.from_numpy(np.ascontiguousarray(
            inp[n][:, :, r * S:(r + 1) * S])) for n in "qkv")
        return sp.ring_attention(q, k, v, "sep", causal=True)

    def schedule():
        return [list(map(list, sp.ring_schedule(4, i, True)))
                for i in range(4)]

    def gpt(method):
        _reset_fleet()
        from paddle_tpu_torch.bridge import load_jax_params
        from paddle_tpu_torch.models import gpt as tgpt

        fleet.init(is_collective=True, strategy=fleet.DistributedStrategy(
            sep_degree=dist.get_world_size()))
        net = tgpt.GPTForCausalLM(tgpt.gpt_tiny(sequence_parallel=method),
                                  device="cpu")
        load_jax_params(net, inp["gpt"])
        model = tpt.Model(net)
        model.prepare(optimizer=fleet.distributed_optimizer(
            topt.Adam(learning_rate=1e-3)), loss=net.loss)
        logits = model.predict_batch([inp["gpt_batches"][0]])
        losses = [model.train_batch([ids], [ids])[0]
                  for ids in inp["gpt_batches"]]
        return {"logits": logits, "losses": np.asarray(losses),
                "params": _gathered(model)}

    def gpt_strategy():
        # the fleet toggle: strategy.sequence_parallel sets the knob
        _reset_fleet()
        from paddle_tpu_torch.bridge import load_jax_params
        from paddle_tpu_torch.models import gpt as tgpt

        fleet.init(is_collective=True, strategy=fleet.DistributedStrategy(
            sep_degree=dist.get_world_size(), sequence_parallel=True,
            sequence_parallel_configs={"method": "ulysses"}))
        net = tgpt.GPTForCausalLM(tgpt.gpt_tiny(), device="cpu")
        load_jax_params(net, inp["gpt"])
        model = tpt.Model(net)
        model.prepare(optimizer=fleet.distributed_optimizer(
            topt.Adam(learning_rate=1e-3)), loss=net.loss)
        losses = [model.train_batch([ids], [ids])[0]
                  for ids in inp["gpt_batches"]]
        return {"losses": np.asarray(losses),
                "knob": net.gpt.blocks[0].attn.sequence_parallel}

    cases = [
        ("ring_causal", lambda: attn(sp.ring_attention_sharded, True)),
        ("ring_full", lambda: attn(sp.ring_attention_sharded, False)),
        ("ulysses_causal", lambda: attn(sp.ulysses_attention_sharded, True)),
        ("ulysses_full", lambda: attn(sp.ulysses_attention_sharded, False)),
        ("ring_local", local_ring),
        ("schedule", schedule),
        ("gpt_ring", lambda: gpt("ring")),
        ("gpt_ulysses", lambda: gpt("ulysses")),
        ("gpt_strategy", gpt_strategy),
    ]
    return _run(cases)


# -- on the card ---------------------------------------------------------------
def card_world():
    """A world on cuda:0 (ranks sharing the card over gloo, or one NCCL
    rank): collectives on card tensors, and ring attention over ``sep`` =
    the world through kernels 4-6, against the plain whole-sequence
    attention in float32 (forward and the gradients of ``sum(out * do)``)."""
    import importlib

    tpt.set_device("cuda:0")
    torch.cuda.set_device(0)
    n, r = dist.get_world_size(), dist.get_rank()
    set_mesh(build_mesh(sep=n))
    dist.reset_collective_stats()
    gen = torch.Generator().manual_seed(0)
    a = torch.randn(n, 64, 33, generator=gen)
    summed = dist.all_reduce(a[r].cuda(), group="sep").cpu()
    gathered = torch.stack(dist.all_gather(a[r].cuda(), group="sep")).cpu()
    fa = importlib.import_module("paddle_tpu_torch.ops.flash_attention")
    q, k, v, do = (torch.randn(2, 4, 256, 64, generator=gen).cuda()
                   .bfloat16() for _ in range(4))
    ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
    for c in (fa.flash_attention, fa.flash_attention_bwd_dq,
              fa.flash_attention_bwd_dkv):
        c.launches = 0
    out = dist.sequence_parallel.ring_attention_sharded(*ins, "sep",
                                                        causal=True)
    out.backward(do)
    launches = [c.launches for c in (fa.flash_attention,
                                     fa.flash_attention_bwd_dq,
                                     fa.flash_attention_bwd_dkv)]
    f32 = [t.float() for t in (q, k, v, do)]
    ref, lse = fa.flash_attention_fwd_lse_ref(*f32[:3], True)
    grads = fa.flash_attention_bwd_ref(*f32[:3], ref, lse, f32[3], True)

    def rel(got, want):
        return float((got.float() - want).abs().max() / want.abs().max())

    return {"all_reduce_err": float((summed - a.sum(0)).abs().max()),
            "all_gather_err": float((gathered - a).abs().max()),
            "stats": dist.collective_stats(), "launches": launches,
            "out_err": rel(out, ref),
            "grad_errs": [rel(t.grad, g) for t, g in zip(ins, grads)]}
