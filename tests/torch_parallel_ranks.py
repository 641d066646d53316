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


def spawn(scenario, world, tmpdir, inputs, timeout=TIMEOUT_S):
    """Start ``scenario`` on ``world`` gloo ranks; returns a function that
    waits for them and gives rank 0's results (the caller works on its
    references meanwhile).  ``timeout``: seconds a collective waits before
    it raises."""
    import torch.multiprocessing as mp

    tmpdir = str(tmpdir)
    with open(os.path.join(tmpdir, "inputs.pkl"), "wb") as f:
        pickle.dump(inputs, f)
    ctx = mp.start_processes(_run, args=(world, tmpdir, scenario, timeout),
                             nprocs=world, start_method="spawn", join=False)

    def results():
        while not ctx.join():
            pass
        with open(os.path.join(tmpdir, "out.pkl"), "rb") as f:
            return pickle.load(f)

    return results


def _run(rank, world, tmpdir, scenario, timeout=TIMEOUT_S):
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
        init_method=f"file://{tmpdir}/store", timeout=timeout)
    assert up and dist.get_backend() == "gloo"
    try:
        with open(os.path.join(tmpdir, "inputs.pkl"), "rb") as f:
            inputs = pickle.load(f)
        out = SCENARIOS[scenario](rank, inputs, tmpdir) \
            if scenario in WITH_DIR else SCENARIOS[scenario](rank, inputs)
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


# ---------------------------------------------------------------------------
# the scoring engine on a mesh
# ---------------------------------------------------------------------------

def _engine(case, mesh=None, **ecfg):
    """The port's engine of a case (``cfg``, numpy ``params``, ``words``
    of a ``WordTokenizer``; or ``t5``) on ``mesh``."""
    from llm_interpretation_replication_tpu_torch.models import config, convert
    from llm_interpretation_replication_tpu_torch.runtime import engine
    from llm_interpretation_replication_tpu_torch.utils import tokenizer

    if "t5" in case:
        from llm_interpretation_replication_tpu_torch.models import t5

        cfg = case["t5"]
        sd = to_torch(case["state_dict"])
        weights = t5.T5Weights(cfg, convert.CONVERTERS["t5"](sd.__getitem__,
                                                            cfg))
        tok = tokenizer.load_tokenizer(case["tokenizer"])
        family = "t5"
    else:
        cfg = config.DecoderConfig(**case["cfg"])
        weights = convert.params_from_jax(case["params"], cfg, device="cpu",
                                          dtype="fp32")
        tok = tokenizer.WordTokenizer(case["words"])
        family = "falcon"
    eng = engine.ScoringEngine(family, cfg, weights, tok, device="cpu",
                               engine_config=engine.EngineConfig(**ecfg))
    return eng.bind_mesh(mesh) if mesh is not None else eng


def _score(eng, call, case):
    if call == "prompts":
        return eng.score_prompts(case["prompts"], case["targets"])
    if call == "confidence":
        return eng.score_prompts(case["prompts"], case["targets"],
                                 with_confidence=True, max_new_tokens=4)
    if call == "prefixed":
        from llm_interpretation_replication_tpu_torch.runtime.engine import \
            LegSpec

        return eng.score_prefixed(
            case["pairs"], case["targets"],
            legs=[LegSpec("binary"),
                  LegSpec("confidence", with_confidence=True,
                          max_new_tokens=4)])
    if call == "packed":
        from llm_interpretation_replication_tpu_torch.scoring import packed

        return eng.score_packed(packed.build_packs(case["prompts"], 2),
                                case["targets"])
    raise ValueError(call)


def _absmax_codes(inputs):
    """Item of the w8a8 trap: one row-parallel input's codes on this rank,
    from the rank's own absmax and from the model axis's."""
    import torch

    from llm_interpretation_replication_tpu_torch.models.config import \
        DecoderConfig
    from llm_interpretation_replication_tpu_torch.ops import quant
    from llm_interpretation_replication_tpu_torch.parallel import (
        make_mesh, tensor_parallel)

    mesh = make_mesh(data=2, model=4)
    tp = tensor_parallel.for_mesh(DecoderConfig(**inputs["cfg"]), mesh)
    first, count = tp.ffn
    x = torch.from_numpy(inputs["activation"])[..., first:first + count]
    return dict(cols=(first, count),
                local=quant.quantize_activations(x)[0].numpy(),
                port=quant.quantize_activations(x, group=tp.group)[0].numpy())


def engine_eight(rank, inputs):
    """Every case of ``inputs["cases"]`` (name -> (case key, mesh kwargs,
    engine kwargs, call)) on 8 ranks, the meshless port rows of
    ``inputs["meshless"]`` beside them, and the absmax codes."""
    from llm_interpretation_replication_tpu_torch.parallel import make_mesh

    out = {}
    for name, (key, mesh_kw, ecfg, call) in inputs["cases"].items():
        case = inputs[key]
        out[name] = _score(_engine(case, make_mesh(**mesh_kw), **ecfg),
                           call, case)
        if name in inputs["meshless"]:
            out[name + "/meshless"] = _score(_engine(case, **ecfg), call,
                                             case)
    out["absmax"] = _absmax_codes(inputs["falcon"])
    return out


def _oom_on_rank_one(rank, rows):
    """Make ``decoder.prefill`` raise a device OOM on rank 1 above ``rows``
    rows a rank."""
    import torch

    from llm_interpretation_replication_tpu_torch.models import decoder

    real = decoder.prefill

    def prefill(params, cfg, ids, *args, **kwargs):
        if rank == 1 and ids.shape[0] > rows:
            raise torch.OutOfMemoryError("CUDA out of memory (injected)")
        return real(params, cfg, ids, *args, **kwargs)

    decoder.prefill = prefill
    return real


def _decode_gather(case):
    """A prefill of 3 rows on dp2 (rank 1's block padded) and a 4-step
    decode from its cache: the slots of every K/V block the decode
    gathers, its all_gather calls, and the calls against the meshless
    ones."""
    import torch
    import torch.distributed as dist

    from llm_interpretation_replication_tpu_torch.models import decoder
    from llm_interpretation_replication_tpu_torch.parallel import make_mesh
    from llm_interpretation_replication_tpu_torch.runtime import row_parallel

    eng = _engine(case, make_mesh(data=2))
    ids = torch.from_numpy(np.random.default_rng(3).integers(1, 300, (3, 9)))
    mask = torch.ones_like(ids, dtype=torch.int32)
    steps = (mask.sum(-1), 0, 4, None, None)
    last, cache = eng._dev.prefill(eng.params, eng.cfg, ids, mask,
                                   cache_len=9)
    slots, calls = [], [0]
    real = row_parallel.gather_rows, dist.all_gather

    def gather_rows(xs, *args, **kwargs):
        # a K/V block is [L, b, T, G, D]
        slots.extend(int(t.shape[2]) for t in xs if t.dim() == 5)
        return real[0](xs, *args, **kwargs)

    def all_gather(*args, **kwargs):
        calls[0] += 1
        return real[1](*args, **kwargs)

    row_parallel.gather_rows, dist.all_gather = gather_rows, all_gather
    try:
        toks, _, grown, _, _ = eng._dev.decode_steps(
            eng.params, eng.cfg, cache, last, *steps, with_scores=False)
    finally:
        row_parallel.gather_rows, dist.all_gather = real
    plast, pcache = decoder.prefill(eng.params, eng.cfg, ids, mask,
                                    cache_len=9)
    ptoks, _, pgrown, _, _ = decoder.decode_steps(
        eng.params, eng.cfg, pcache, plast, *steps, with_scores=False)
    return dict(slots=slots, all_gathers=calls[0],
                tokens_equal=bool(torch.equal(toks, ptoks)),
                shape=tuple(grown.k.shape), plain_shape=tuple(pgrown.k.shape),
                k_err=float((grown.k - pgrown.k).abs().max()),
                last_err=float((last - plast).abs().max()))


def engine_two(rank, inputs, tmpdir):
    """On 2 ranks: T5 on tp2, dp1 x seq2 against the meshless engine, an
    OOM on rank 1 of dp2, a dp2 decode's gathers, and ``run-perturbation`` with ``--mesh-model 2``
    and ``--mesh-seq 2`` (each rank its own output directory), then a
    ``--mesh-model 2`` resume from state that only rank 0's directory
    holds."""
    import contextlib
    import io

    from llm_interpretation_replication_tpu_torch import __main__ as cli
    from llm_interpretation_replication_tpu_torch.models import decoder
    from llm_interpretation_replication_tpu_torch.parallel import make_mesh

    out = {}
    t5 = inputs["t5"]
    out["t5_tp2"] = _score(_engine(t5, make_mesh(model=2)), "confidence", t5)
    falcon = inputs["falcon"]
    ecfg = dict(batch_size=8, buckets=(32, 64))
    out["seq2"] = _score(_engine(falcon, make_mesh(seq=2), **ecfg),
                         "prompts", falcon)
    out["seq2/meshless"] = _score(_engine(falcon, **ecfg), "prompts", falcon)
    oom = dict(batch_size=16, buckets=(32, 64), oom_batch_floor=4,
               decode_completions=False)
    real = _oom_on_rank_one(rank, 4)
    try:
        eng = _engine(falcon, make_mesh(data=2), **oom)
        out["oom_dp2"] = _score(eng, "prompts", falcon)
        out["oom_dp2/steps"] = [e["new_batch"] for e in eng.fault_events]
    finally:
        decoder.prefill = real
    out["oom_dp2/meshless"] = _score(_engine(falcon, **oom), "prompts",
                                     falcon)
    out["decode_gather"] = _decode_gather(falcon)
    for flag in ("--mesh-model", "--mesh-seq"):
        where = os.path.join(tmpdir, f"{flag[2:]}{rank}")
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            cli.main(inputs["argv"] + ["--output-dir", where, flag, "2"])
        out[flag] = {r: (sorted(os.listdir(os.path.join(
            tmpdir, f"{flag[2:]}{r}"))) if os.path.isdir(os.path.join(
                tmpdir, f"{flag[2:]}{r}")) else []) for r in (0, 1)}
        out[flag + "/printed"] = printed.getvalue()
    import json

    import torch.distributed as dist

    from llm_interpretation_replication_tpu_torch.utils.xlsx import read_xlsx

    # a resume where only rank 0's directory holds the state: the first
    # half of the --mesh-model run's rows as a side-log; rank 1's is empty
    where = os.path.join(tmpdir, f"resume{rank}")
    os.makedirs(where)
    if rank == 0:
        rows = read_xlsx(os.path.join(tmpdir, "mesh-model0",
                                      "perturbation_results.xlsx"))[1]
        out["resume/kept"] = len(rows) // 2
        with open(os.path.join(where, "perturbation_results.xlsx"
                               ".rows.jsonl"), "w") as f:
            for row in rows[:len(rows) // 2]:
                f.write(json.dumps(row) + "\n")
    dist.barrier()
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        cli.main(inputs["argv"] + ["--output-dir", where, "--mesh-model",
                                   "2"])
    out["resume"] = {r: sorted(os.listdir(os.path.join(tmpdir,
                                                       f"resume{r}")))
                     for r in (0, 1)}
    # rank 1's printed lines and files, for the test to see (rank 0
    # reports): both ranks ran the commands above in step
    lines = [None, None]
    dist.all_gather_object(lines, {f: out[f + "/printed"]
                                   for f in ("--mesh-model", "--mesh-seq")})
    out["printed_by_rank"] = lines
    return out


def oom_inside_tp(rank, inputs, tmpdir):
    """An OOM on rank 1 inside a tp2 forward (the MLP of its first layer,
    after the attention's all-reduce): each rank records its outcome."""
    import time

    import torch

    from llm_interpretation_replication_tpu_torch.models import decoder
    from llm_interpretation_replication_tpu_torch.parallel import make_mesh

    real = decoder._mlp

    def mlp(cfg, lp, x, tp=None):
        if rank == 1:
            raise torch.OutOfMemoryError("CUDA out of memory (injected)")
        return real(cfg, lp, x, tp)

    falcon = inputs["falcon"]
    eng = _engine(falcon, make_mesh(model=2), batch_size=8, buckets=(32, 64))
    decoder._mlp = mlp
    start = time.monotonic()
    try:
        _score(eng, "prompts", falcon)
        outcome = "returned"
    except Exception as err:            # each rank's error is the result
        outcome = f"{type(err).__name__}: {err}"
    with open(os.path.join(tmpdir, f"outcome{rank}.pkl"), "wb") as f:
        pickle.dump((outcome, time.monotonic() - start), f)
    return {}


SCENARIOS = {"train": train_two, "parallel": mesh_attention_pipeline,
             "engine_eight": engine_eight, "engine_two": engine_two,
             "oom_inside_tp": oom_inside_tp}
WITH_DIR = ("engine_two", "oom_inside_tp")
