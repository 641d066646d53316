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

def _engine(case, mesh=None, cls=None, **ecfg):
    """The port's engine of a case (``cfg``, numpy ``params``, ``words``
    of a ``WordTokenizer``; or ``t5``) on ``mesh``; ``cls`` a subclass of
    ``ScoringEngine``."""
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
    eng = (cls or engine.ScoringEngine)(
        family, cfg, weights, tok, device="cpu",
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


# ---------------------------------------------------------------------------
# the MoE MLP, expert-parallel
# ---------------------------------------------------------------------------

def moe_sharded(rank, inputs):
    """``ops.moe.moe_mlp_sharded`` over the world's ranks (one expert block
    a rank) on every case of ``inputs["cases"]``, and the dense path."""
    import torch
    import torch.distributed as dist

    from llm_interpretation_replication_tpu_torch.models.convert import \
        moe_params_from_jax
    from llm_interpretation_replication_tpu_torch.ops import moe
    from llm_interpretation_replication_tpu_torch.parallel import make_mesh

    mesh = make_mesh(data=dist.get_world_size())
    out = {}
    for name, case in inputs["cases"].items():
        params = moe_params_from_jax(case["params"], device="cpu")
        x = torch.from_numpy(case["x"])
        y, aux = moe.moe_mlp_sharded(params, x, mesh, top_k=case["top_k"],
                                     capacity_factor=case["capacity_factor"])
        out[name] = (y.numpy(), float(aux))
    return out


SCENARIOS["moe_sharded"] = moe_sharded


# ---------------------------------------------------------------------------
# slotted scoring, the KV-slab handoff, the K-token decode and serving on
# a mesh
# ---------------------------------------------------------------------------

def admit_once(case, lo, hi):
    """An ``admit_fn`` that admits prompts ``lo:hi`` of the case at its
    first call and nothing after: every rank admits alike."""
    sent = []

    def admit():
        if sent:
            return None
        sent.append(True)
        return case["prompts"][lo:hi], case["targets"][lo:hi]

    return admit


def slotted_rows(eng, case, rows=3, admit=(3, 6)):
    return eng.score_prompts_slotted(case["prompts"][:rows],
                                     case["targets"][:rows],
                                     admit_fn=admit_once(case, *admit))


def slab_rows(exporter, importer, case, rows=6):
    """``export_kv_slab`` on one engine, ``decode_kv_slabs`` on another:
    the rows in prompt order."""
    decided, slabs = exporter.export_kv_slab(case["prompts"][:rows],
                                             case["targets"][:rows])
    decoded = importer.decode_kv_slabs(slabs)
    origs = [m["orig"] for s in slabs for m in s.metas]
    for i, row in zip(origs, decoded):
        decided[i] = row
    return decided, len(origs)


def oracle_class(decode_k=4):
    """chip_smoke's oracle engine of the port (every K block accepted)."""
    import importlib
    import sys

    from llm_interpretation_replication_tpu_torch.models import decoder
    from llm_interpretation_replication_tpu_torch.runtime import engine

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    chip_smoke = importlib.import_module("chip_smoke")
    return chip_smoke.oracle_engine(engine, decoder, decode_k=decode_k)


def _digest(t):
    import hashlib

    return hashlib.sha256(t.float().contiguous().numpy().tobytes()
                          ).hexdigest()


def _k_verify_tp(case, mesh):
    """``decoder.k_verify_block`` with ``tp`` on the rank's blocks against
    the whole call: the chain, the acceptance and the logits, and the
    block's K/V in the tail."""
    import torch

    from llm_interpretation_replication_tpu_torch.models import decoder
    from llm_interpretation_replication_tpu_torch.parallel import \
        tensor_parallel

    whole = _engine(case)
    part = _engine(case).bind_mesh(mesh)
    tp = tensor_parallel.for_mesh(part.cfg, mesh)
    rng = np.random.default_rng(5)
    ids = torch.from_numpy(rng.integers(1, 300, (3, 7)))
    mask = torch.ones_like(ids, dtype=torch.int32)
    lens = mask.sum(-1)
    # rows 0 and 1 propose the greedy chain (accepted), row 2 a wrong
    # third token (a prefix of 2 accepted)
    last, cache = decoder.prefill(whole.params, whole.cfg, ids, mask, 7)
    props = decoder.decode_steps(whole.params, whole.cfg, cache, last, lens,
                                 0, 3, with_scores=False)[0]
    props[2, 2] = (props[2, 2] + 1) % whole.cfg.vocab_size
    out = {}
    for name, eng, kw in (("whole", whole, {}), ("tp", part, {"tp": tp})):
        last, cache = decoder.prefill(eng.params, eng.cfg, ids, mask, 7,
                                      **kw)
        shape = (eng.cfg.num_layers, 3, 4, cache.k.shape[3],
                 eng.cfg.head_dim)
        tk, tv = torch.zeros(shape), torch.zeros(shape)
        got = decoder.k_verify_block(
            eng.params, eng.cfg, cache, tk, tv, last, lens, 0, 0, props,
            None, None, torch.zeros((3, 2), dtype=torch.long), fold=True,
            **kw)
        out[name] = dict(tokens=got.tokens.numpy(), a_len=got.a_len.numpy(),
                         accepted=got.accepted.numpy(),
                         logits=got.last_logits.numpy(),
                         hidden=got.last_hidden.numpy(),
                         tail=tk[:, :, :3].numpy(),
                         folded=got.cache.k.numpy())
    return out


def serve_two(rank, inputs, tmpdir):
    """On 2 ranks: slotted scoring with an admission on dp2 (3 rows) and
    tp2, a KV slab exported on dp2 and decoded on tp2 (and, for a model
    whose two K/V heads tp2 splits, the other way round), oracle K=4 rows on
    dp2 (3 rows) and tp2 with the K=1 rows beside them, a distilled
    K-head's digest on each rank, ``k_verify_block(tp=)`` against the whole
    call, a pool of two replicas on rank slices, and ``serve`` through
    ``__main__`` (``--replay`` and the JSONL driver) on ``--mesh-model 2``."""
    import contextlib
    import io

    import torch.distributed as dist

    from llm_interpretation_replication_tpu_torch import __main__ as cli
    from llm_interpretation_replication_tpu_torch.parallel import make_mesh

    falcon = inputs["falcon"]
    pooled = dict(batch_size=8, buckets=(32, 64), decode_completions=False)
    ecfg = dict(batch_size=8, buckets=(32, 64), max_new_tokens=20)
    dp2, tp2 = make_mesh(data=2), make_mesh(model=2)
    out = {}
    out["slotted_dp2"] = slotted_rows(_engine(falcon, dp2, **pooled), falcon)
    out["slotted_tp2"] = slotted_rows(_engine(falcon, tp2, **pooled), falcon)
    out["slotted/meshless"] = slotted_rows(_engine(falcon, **pooled), falcon)
    out["slabs"] = slab_rows(_engine(falcon, dp2, **pooled),
                             _engine(falcon, tp2, **pooled), falcon)
    out["slabs/meshless"] = slab_rows(_engine(falcon, **pooled),
                                      _engine(falcon, **pooled), falcon)
    # two K/V heads, which tp2 splits: the slab gathers them on export
    gqa = inputs["gqa"]
    out["slabs_gqa"] = slab_rows(_engine(gqa, tp2, **pooled),
                                 _engine(gqa, dp2, **pooled), gqa)
    out["slabs_gqa/meshless"] = slab_rows(_engine(gqa, **pooled),
                                          _engine(gqa, **pooled), gqa)
    from llm_interpretation_replication_tpu_torch.utils import telemetry

    oracle = oracle_class()
    prompts, targets = falcon["prompts"], falcon["targets"]
    for name, mesh, rows in (("dp2", dp2, 3), ("tp2", tp2, 4)):
        telemetry.clear_counters()
        out[f"k4_{name}"] = _engine(
            falcon, mesh, cls=oracle, decode_k=4, **ecfg).score_prompts(
                prompts[:rows], targets[:rows])
        out[f"k4_{name}/counters"] = {
            k: telemetry.counter(k) for k in ("k_blocks_proposed",
                                              "k_blocks_rejected")}
        out[f"k1_{name}"] = _engine(falcon, mesh, **ecfg).score_prompts(
            prompts[:rows], targets[:rows])
    out["k4/meshless"] = _engine(falcon, cls=oracle, decode_k=4,
                                 **ecfg).score_prompts(prompts, targets)
    heads = {}
    for name, mesh in (("dp2", dp2), ("tp2", tp2), ("meshless", None)):
        eng = _engine(falcon, mesh, decode_k=4, **ecfg)
        head = eng.distill_k_head_on(prompts[:5], gen_steps=6)["w"]
        digests = [None, None]
        dist.all_gather_object(digests, _digest(head))
        heads[name] = (digests, head.numpy())
        out[f"distilled_{name}"] = eng.score_prompts(prompts[:3],
                                                     targets[:3])
    out["heads"] = heads
    out["k_verify_tp"] = _k_verify_tp(falcon, tp2)
    out["k_verify_tp/by_rank"] = [None, None]
    dist.all_gather_object(out["k_verify_tp/by_rank"],
                           out["k_verify_tp"]["tp"]["tokens"].tolist())
    out["pool"] = pool_on_slices(falcon, 2, prompts[:8], targets[:8])
    printed = {}
    for name, argv in inputs["serve"].items():
        buf = io.StringIO()
        argv = [a.replace("{rank}", str(rank)) for a in argv]
        with contextlib.redirect_stdout(buf):
            try:
                cli.main(argv)
                code = 0
            except SystemExit as stop:
                code = stop.code
        printed[name] = (code, buf.getvalue())
    lines = [None, None]
    dist.all_gather_object(lines, printed)
    out["serve"] = lines
    return out


def pool_on_slices(case, n_slices, prompts, targets):
    """An ``EnginePool`` of ``n_slices`` replicas on
    ``carve_slices(n_slices)`` of the world: rank 0 submits, every rank
    closes.  Returns rank 0's rows, its health doc, and each rank's
    hosted replicas."""
    import torch.distributed as dist

    from llm_interpretation_replication_tpu_torch.parallel import mesh
    from llm_interpretation_replication_tpu_torch.serve import (
        EnginePool, ScoreRequest)
    from llm_interpretation_replication_tpu_torch.serve.config import \
        SchedulerConfig
    from llm_interpretation_replication_tpu_torch.serve.pool import PoolConfig

    rank = dist.get_rank()
    pool = EnginePool(PoolConfig(scheduler=SchedulerConfig(max_wait_s=0.0)))
    for sl in mesh.carve_slices(n_slices):
        pool.load("m", _engine(case, batch_size=8, buckets=(32, 64),
                               decode_completions=False)
                  if rank in sl else None, devices=sl)
    rows = health = None
    if pool.leads:
        futures = [pool.submit(ScoreRequest(prompt=p, targets=tuple(t)))
                   for p, t in zip(prompts, targets)]
        rows = [f.result(timeout=TIMEOUT_S) for f in futures]
        health = pool.health()
    hosted = sorted(r.rid for r in pool.replicas()
                    if getattr(r, "hosted", False))
    pool.close()
    everyone = [None] * dist.get_world_size()
    dist.all_gather_object(everyone, hosted)
    return dict(rows=rows, health=health, hosted=everyone)


def pool_four(rank, inputs):
    """A pool of two replicas on ``carve_slices(2)`` of 4 ranks: each
    replica's slice is dp2, led by its first rank."""
    case = inputs["falcon"]
    return pool_on_slices(case, 2, case["prompts"][:8], case["targets"][:8])


def leader_exits(rank, inputs, tmpdir):
    """A dp2 scheduler whose leader's process exits while its follower
    waits for a decision: the follower's outcome and how long it took."""
    import time

    from llm_interpretation_replication_tpu_torch.parallel import make_mesh
    from llm_interpretation_replication_tpu_torch.serve.scheduler import \
        Scheduler

    eng = _engine(inputs["falcon"], make_mesh(data=2), batch_size=8,
                  buckets=(32, 64), decode_completions=False)
    sched = Scheduler(eng).start()
    if rank == 0:
        with open(os.path.join(tmpdir, "out.pkl"), "wb") as f:
            pickle.dump({}, f)
        time.sleep(0.5)
        os._exit(0)
    start = time.monotonic()
    try:
        sched.close()
        outcome = "returned"
    except Exception as err:             # the follower's error is the result
        outcome = f"{type(err).__name__}: {err}"
    with open(os.path.join(tmpdir, "follower.pkl"), "wb") as f:
        pickle.dump((outcome, time.monotonic() - start), f)
    return {}


SCENARIOS.update(serve_two=serve_two, pool_four=pool_four,
                 leader_exits=leader_exits)
WITH_DIR = WITH_DIR + ("serve_two", "leader_exits")
