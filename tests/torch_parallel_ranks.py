"""Per-rank bodies of the port's multi-rank CPU tests.

Each scenario runs in spawned processes, one a rank, over a gloo process
group (``parallel.mesh.initialize_distributed(device="cpu")`` with a
``file://`` rendezvous).  The test writes the scenario's numpy inputs to
a pickle; every rank reads them, and rank 0 writes its results for the
test to hold against the JAX package.  Imports no JAX.
"""

import os
import pickle

import numpy as np

TIMEOUT_S = 120          # a collective that waits longer raises


def np_decoder_params(cfg, seed, scale=0.05):
    """Random float32 params in the stacked layout of either package's
    decoder: norms at scale 1 (+ bias 0, or a small bias when the config
    has projection biases), projections and biases N(0, scale^2)."""
    rng = np.random.default_rng(seed)
    h, d = cfg.hidden_size, cfg.head_dim
    nd, kvd = cfg.num_heads * d, cfg.num_kv_heads * d
    L, F, V = cfg.num_layers, cfg.intermediate_size, cfg.vocab_size

    def init(*shape):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    def norm(*lead):
        out = {"scale": (1 + init(*lead, h)).astype(np.float32)}
        if cfg.norm_type == "layernorm":
            out["bias"] = init(*lead, h)
        return out

    attn = {"wq": init(L, h, nd), "wk": init(L, h, kvd),
            "wv": init(L, h, kvd), "wo": init(L, nd, h)}
    if cfg.qkv_bias:
        attn.update(bq=init(L, nd), bk=init(L, kvd), bv=init(L, kvd))
    if cfg.out_bias:
        attn["bo"] = init(L, h)
    mlp = {"wi": init(L, h, F), "wo": init(L, F, h)}
    if cfg.mlp_type == "gated":
        mlp["wg"] = init(L, h, F)
    if cfg.mlp_bias:
        mlp.update(bi=init(L, F), bo=init(L, h))
        if cfg.mlp_type == "gated":
            mlp["bg"] = init(L, F)
    layers = {"ln1": norm(L), "attn": attn, "mlp": mlp}
    if not (cfg.parallel_residual and cfg.shared_layernorm):
        layers["ln2"] = norm(L)
    params = {"embed": {"tokens": init(V, h)}, "layers": layers,
              "final_ln": norm()}
    if not cfg.tie_word_embeddings:
        params["lm_head"] = init(h, V)
    return params


def to_torch(tree):
    import torch

    if isinstance(tree, dict):
        return {k: to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def to_numpy(tree):
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy()


def spawn(scenario, world, tmpdir, inputs):
    """Start ``scenario`` on ``world`` gloo ranks; returns a function that
    waits for them and gives rank 0's results (the caller works on its
    references meanwhile)."""
    import torch.multiprocessing as mp

    tmpdir = str(tmpdir)
    with open(os.path.join(tmpdir, "inputs.pkl"), "wb") as f:
        pickle.dump(inputs, f)
    ctx = mp.start_processes(_run, args=(world, tmpdir, scenario),
                             nprocs=world, start_method="spawn", join=False)

    def results():
        while not ctx.join():
            pass
        with open(os.path.join(tmpdir, "out.pkl"), "rb") as f:
            return pickle.load(f)

    return results


def _run(rank, world, tmpdir, scenario):
    import torch
    import torch.distributed as dist

    from llm_interpretation_replication_tpu_torch.parallel import mesh

    # one thread, and behind the suite's other workers: their timed
    # legs (a serve load of 0.4 s a rate) share these cores
    torch.set_num_threads(1)
    os.nice(10)
    os.environ.pop("MASTER_ADDR", None)
    # the timeout turns a hang into an error
    up = mesh.initialize_distributed(
        num_processes=world, process_id=rank, device="cpu",
        init_method=f"file://{tmpdir}/store", timeout=TIMEOUT_S)
    assert up and dist.get_backend() == "gloo"
    try:
        with open(os.path.join(tmpdir, "inputs.pkl"), "rb") as f:
            inputs = pickle.load(f)
        out = SCENARIOS[scenario](rank, inputs)
        if rank == 0:
            with open(os.path.join(tmpdir, "out.pkl"), "wb") as f:
                pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def _unshard(tree, cfg, mesh):
    """The full tensors of a tree of the rank's blocks."""
    from llm_interpretation_replication_tpu_torch.parallel import sharding

    specs = sharding.param_specs(tree)
    cut = sharding.model_sharded_leaves(tree, cfg, mesh)

    def walk(t, s, path=()):
        if isinstance(t, dict):
            return {k: walk(t[k], s[k], path + (k,)) for k in t}
        if not cut[path]:
            return t
        return sharding.constrain(t, mesh, (), current=s)

    return walk(tree, specs)


def _train_case(case, mesh):
    import torch

    from llm_interpretation_replication_tpu_torch.models.config import \
        DecoderConfig
    from llm_interpretation_replication_tpu_torch.parallel import shard_params
    from llm_interpretation_replication_tpu_torch.runtime import train

    cfg = DecoderConfig(**case["cfg"])
    ids = torch.from_numpy(case["ids"]).long()
    mask = torch.from_numpy(case["mask"])
    local = shard_params(to_torch(case["params"]), mesh, cfg=cfg)
    opt = train.make_optimizer(**case["opt"])
    state = train.init_train_state(local, opt)
    loss, grads = train.loss_and_grads(state.params, cfg, ids, mask, mesh)
    norm = train.grad_norm(grads, cfg, mesh)
    step = train.make_train_step(cfg, opt, mesh)
    losses = []
    for _ in range(case["steps"]):
        state, step_loss = step(state, ids, mask)
        losses.append(float(step_loss))
    return dict(loss=float(loss), norm=float(norm),
                grads=to_numpy(_unshard(grads, cfg, mesh)),
                params=to_numpy(_unshard(state.params, cfg, mesh)),
                losses=losses)


def train_two(rank, inputs):
    from llm_interpretation_replication_tpu_torch.parallel import make_mesh

    out = {}
    for name, case in inputs.items():
        out[name] = _train_case(case, make_mesh(**case["mesh"]))
    return out


# ---------------------------------------------------------------------------
# meshes, ring and Ulysses attention, the pipeline
# ---------------------------------------------------------------------------

def _mesh_facts():
    import torch.distributed as dist

    from llm_interpretation_replication_tpu_torch.config import RunConfig
    from llm_interpretation_replication_tpu_torch.parallel import (
        initialize_distributed, make_mesh, mesh as pmesh)

    out = {}
    for name, kw in (("model2", dict(model=2)), ("pipe4", dict(pipe=4)),
                     ("model2_seq2", dict(model=2, seq=2)),
                     ("subset", dict(devices=[0, 1], model=2))):
        m = make_mesh(**kw)
        out[name] = dict(
            shape=tuple(m.mesh.shape), names=m.mesh_dim_names,
            device_type=m.device_type,
            model_group=(dist.get_process_group_ranks(m.get_group("model"))
                         if m.get_coordinate() is not None else None))
    try:
        make_mesh(data=3)
    except ValueError as e:
        out["data3"] = str(e)
    out["run_config"] = tuple(RunConfig(mesh_model=2).make_mesh().mesh.shape)
    out["again"] = initialize_distributed(device="cpu")
    out["carve2"] = pmesh.carve_slices(2)
    out["carve_counts"] = pmesh.carve_slices(counts=(3, 1))
    return out


def _attention_cases(inputs):
    import torch

    from llm_interpretation_replication_tpu_torch.parallel import (
        make_mesh, ring_attention_sharded, ulysses_attention_sharded)

    fns = {"ring": ring_attention_sharded, "ulysses": ulysses_attention_sharded}
    out = {}
    for name, (fn, kw, arrays, causal) in inputs["attention"].items():
        q, k, v, mask = (torch.from_numpy(a) for a in arrays)
        with torch.no_grad():
            got = fns[fn](make_mesh(**kw), q, k, v, mask, causal=causal)
        out[name] = got.numpy()
    q, k, v, mask = (torch.from_numpy(a) for a in inputs["indivisible"])
    try:
        with torch.no_grad():
            ulysses_attention_sharded(make_mesh(seq=4), q, k, v, mask)
    except ValueError as e:
        out["indivisible"] = str(e)
    q.requires_grad_(True)
    try:
        ring_attention_sharded(make_mesh(seq=4), q, k, v, mask)
    except NotImplementedError as e:
        out["ring_grad"] = str(e)
    return out


def _pipeline_cases(inputs):
    import torch
    import torch.distributed as dist

    from llm_interpretation_replication_tpu_torch.models.config import \
        DecoderConfig
    from llm_interpretation_replication_tpu_torch.parallel import (
        make_mesh, pipeline_apply, pipeline_decoder_forward)

    out = {}
    pipe4 = make_mesh(pipe=4)
    scales = torch.from_numpy(inputs["affine_scales"])
    xs = torch.from_numpy(inputs["affine_xs"])
    with torch.no_grad():
        out["affine"] = pipeline_apply(lambda p, x: x * p[0] + 1.0, scales,
                                       xs, pipe4).numpy()
    out["single"] = pipeline_apply(
        lambda p, x: x * p[0], torch.ones(4, 1) * 1.5, torch.ones(1, 2, 3),
        pipe4).detach().numpy()
    # the gradient through the hand-offs: backward() and autograd.grad
    xs = torch.from_numpy(inputs["grad_xs"])
    for how in ("backward", "autograd_grad"):
        scales = torch.tensor([[1.0], [2.0], [3.0], [4.0]], requires_grad=True)
        loss = pipeline_apply(lambda sp, x: x * sp[0], scales, xs, pipe4).sum()
        if how == "backward":
            loss.backward()
            g = scales.grad
        else:
            g, = torch.autograd.grad(loss, [scales])
        g = g.clone()
        dist.all_reduce(g, group=pipe4.get_group("pipe"))
        out[f"grad_{how}"] = g.numpy()
        out[f"loss_{how}"] = float(loss.detach())

    mesh = make_mesh(pipe=2, model=2)
    ids = torch.from_numpy(inputs["ids"]).long()
    for name, (kw, params, mask) in inputs["decoders"].items():
        with torch.no_grad():
            out[name] = pipeline_decoder_forward(
                to_torch(params), DecoderConfig(**kw), ids,
                torch.from_numpy(mask), mesh, n_microbatches=2).numpy()
    kw, params, _ = inputs["decoders"]["dense"]
    try:
        pipeline_decoder_forward(to_torch(params), DecoderConfig(**kw),
                                 torch.ones(3, 8, dtype=torch.long),
                                 torch.ones(3, 8, dtype=torch.long), mesh)
    except ValueError as e:
        out["pipeline_indivisible"] = str(e)
    return out


def mesh_attention_pipeline(rank, inputs):
    out = _mesh_facts()
    out.update(_attention_cases(inputs))
    out.update(_pipeline_cases(inputs))
    return out


SCENARIOS = {"train": train_two, "parallel": mesh_attention_pipeline}
