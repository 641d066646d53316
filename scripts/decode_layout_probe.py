"""Does a row's decode on the card depend on how far its cache pads the
slot axis, and what does each way of making it independent cost?  Run on
the H100:

    python3 scripts/decode_layout_probe.py [--variants=a,b,...]
        [--sections=padding,timing,extend,ring,products]

Decode attentions (``VARIANTS``; all by default): ``float32`` (float32
softmax sums, bf16 products, the two blocks apart), ``f64_sums`` (the
same with the softmax denominator summed in float64), ``f64_pv`` (that,
with the probabilities times V in float64 and the blocks' outputs joined
in float64 before the one rounding), ``float64`` (the blocks joined, the
score products and both slot sums in float64), ``fp32_apart`` (this
tree's structure in float32), ``f64_qk`` (this tree's structure with
the probabilities times V left in bf16 as the float32 attention had
them: only K is converted) and ``this_tree`` (the tree's
``grouped_attention_two_block``: the blocks apart, each converted to
float64 by one copy).  For Falcon-7B (MQA), BLOOM-7b1 (MHA, ALiBi) and
Mistral-7B-v0.2 (GQA) at full width and depth (random bf16 weights, seed
0), by section:

- ``padding``: 31 rows of 90-112 tokens decode two 5-step chunks from
  caches of 112, 128, 256 and 448 slots, and from the 448-slot cache
  compacted as a slot ring compacts it (``448c``); the rows whose scores
  are bit-identical to the 112-slot cache's, per cache and chunk;
- ``timing``: a 10-step decode chunk of 32 rows at bucket 64 and 448,
  the variants in turns (forward, then backward), mean of three calls
  each (``chunk_ms``); the decode attention alone at those shapes (32
  rows, one query, the bucket's cache plus a 5-slot tail), mean of 20
  calls (``attention_us``);
- ``extend`` (Falcon-7B): a 35-token suffix extension over prefix caches
  of 112 and 128 slots under the extension attentions, rows equal;
- ``ring`` (Falcon-7B): the engine's ring route (384 prompts of 100-440
  tokens, batch 32, pool target 16) with rings padded to their capacity
  (this tree) against rings shrunk to the slice menu, rows/s;
- ``products``: every roster family's bf16 projection shapes at 1-96
  rows against the same rows of a 128-row product, with and without
  padding to 64 rows (``rows_padded``), and its float32 unembedding.

Prints one JSON line and writes ``chiprun_out/decode_layout_probe.json``."""

import importlib
import json
import math
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

import chip_smoke as cs
from llm_interpretation_replication_tpu_torch.models import config as mconfig
from llm_interpretation_replication_tpu_torch.models import convert, decoder
from llm_interpretation_replication_tpu_torch.ops import _build
from llm_interpretation_replication_tpu_torch.runtime import batching
from llm_interpretation_replication_tpu_torch.runtime import engine as emod
from llm_interpretation_replication_tpu_torch.runtime import slots as slots_mod

# the package re-exports a function under the module's name
attn = importlib.import_module(
    "llm_interpretation_replication_tpu_torch.ops.attention")
bias_grouped = getattr(decoder, "_bias_grouped", None) or attn._bias_grouped


def _scores(q, k, bias):
    b, s, n, d = q.shape
    g = k.shape[2]
    scale = torch.tensor(math.sqrt(d), dtype=q.dtype)
    qg = q.reshape(b, s, g, n // g, d)
    return (torch.einsum("bsghd,btgd->bghst", qg, k) / scale).float() \
        + bias_grouped(bias, b, n, g, s, k.shape[1])


def _two_block(f64_sums, f64_pv):
    def fn(q, kp, vp, bias_p, kt, vt, bias_t):
        b, s, n, d = q.shape
        sp, st = _scores(q, kp, bias_p), _scores(q, kt, bias_t)
        m = torch.maximum(sp.amax(-1, keepdim=True),
                          st.amax(-1, keepdim=True))
        ep, et = torch.exp(sp - m), torch.exp(st - m)
        dt = torch.float64 if f64_sums else None
        denom = ep.sum(-1, keepdim=True, dtype=dt) \
            + et.sum(-1, keepdim=True, dtype=dt)
        pp, pt = (ep / denom).to(q.dtype), (et / denom).to(q.dtype)
        if f64_pv:
            out = (torch.einsum("bghst,btgd->bsghd", pp.double(), vp.double())
                   + torch.einsum("bghst,btgd->bsghd", pt.double(),
                                  vt.double())).to(q.dtype)
        else:
            out = (torch.einsum("bghst,btgd->bsghd", pp, vp)
                   + torch.einsum("bghst,btgd->bsghd", pt, vt))
        return out.reshape(b, s, n, d)
    return fn


def float64_joined(q, kp, vp, bias_p, kt, vt, bias_t):
    """Blocks joined, score products and both slot sums in float64."""
    b, s, n, d = q.shape
    g = kp.shape[2]
    k = torch.cat([kp, kt], dim=1).double()
    v = torch.cat([vp, vt], dim=1).double()
    bias = torch.cat([bias_grouped(bias_p, b, n, g, s, kp.shape[1]),
                      bias_grouped(bias_t, b, n, g, s, kt.shape[1])], dim=-1)
    qg = q.reshape(b, s, g, n // g, d).double()
    scale = torch.tensor(math.sqrt(d), dtype=q.dtype)
    scores = (torch.einsum("bsghd,btgd->bghst", qg, k).to(q.dtype)
              / scale).float() + bias
    e = torch.exp(scores - scores.amax(-1, keepdim=True))
    p = (e / e.sum(-1, keepdim=True, dtype=torch.float64)).to(q.dtype)
    out = torch.einsum("bghst,btgd->bsghd", p.double(), v)
    return out.to(q.dtype).reshape(b, s, n, d)


def _apart(acc, pv=True):
    """This tree's structure (blocks apart, one converting copy a block)
    with ``acc`` for the score products and slot sums.  ``pv=False``
    keeps the probabilities times V in the query dtype, each block's
    output rounded and the two added, as the float32 attention did: V is
    never converted, only K."""
    def fn(q, kp, vp, bias_p, kt, vt, bias_t):
        b, s, n, d = q.shape
        g = kp.shape[2]
        h = n // g
        qa = q.reshape(b, s, g, h, d).permute(0, 2, 3, 1, 4).reshape(
            b * g, h * s, d).to(acc)
        scale = torch.tensor(math.sqrt(d), dtype=q.dtype)

        def conv(x, dtype=acc):
            out = torch.empty((b, g, x.shape[1], d), dtype=dtype,
                              device=x.device)
            out.copy_(x.transpose(1, 2))
            return out.view(b * g, x.shape[1], d)

        blocks = [(conv(k), conv(v, acc if pv else q.dtype), bias)
                  for k, v, bias in ((kp, vp, bias_p), (kt, vt, bias_t))]
        scores = [(torch.bmm(qa, k.transpose(1, 2)).to(q.dtype) / scale)
                  .float().view(b, g, h, s, k.shape[1])
                  + bias_grouped(bias, b, n, g, s, k.shape[1])
                  for k, _, bias in blocks]
        m = torch.maximum(*(sc.amax(-1, keepdim=True) for sc in scores))
        exps = [torch.exp(sc - m) for sc in scores]
        denom = sum(e.sum(-1, keepdim=True, dtype=torch.float64)
                    for e in exps)
        probs = [(e / denom).to(q.dtype).view(b * g, h * s, -1)
                 for e in exps]
        if pv:
            out = sum(torch.bmm(p.to(acc), v)
                      for p, (_, v, _) in zip(probs, blocks))
        else:
            out = sum(torch.bmm(p, v) for p, (_, v, _) in zip(probs, blocks))
        return out.to(q.dtype).view(b, g, h, s, d).permute(0, 3, 1, 2, 4) \
            .reshape(b, s, n, d)
    return fn


VARIANTS = {
    "float32": _two_block(False, False),
    "f64_sums": _two_block(True, False),
    "f64_pv": _two_block(True, True),
    "float64": float64_joined,
    "fp32_apart": _apart(torch.float32),
    "f64_qk": _apart(torch.float64, pv=False),
}


def _extend(mode):
    def fn(q, kp, vp, kt, vt, bias, kp_scale=None, vp_scale=None):
        k, v = torch.cat([kp, kt], 1), torch.cat([vp, vt], 1)
        b, t, g, d = k.shape
        n = q.shape[2]
        if g != n:
            k = k[:, :, :, None].expand(b, t, g, n // g, d).reshape(b, t, n, d)
            v = v[:, :, :, None].expand(b, t, g, n // g, d).reshape(b, t, n, d)
        scale = torch.tensor(math.sqrt(d), dtype=q.dtype)
        if mode == "float64":
            sc = torch.einsum("bsnd,btnd->bnst", q.double(),
                              k.double()).to(q.dtype) / scale
        else:
            sc = torch.einsum("bsnd,btnd->bnst", q, k) / scale
        sc = sc.float() + bias
        e = torch.exp(sc - sc.amax(-1, keepdim=True))
        dt = None if mode == "float32" else torch.float64
        p = (e / e.sum(-1, keepdim=True, dtype=dt)).to(q.dtype)
        if mode == "float64":
            return torch.einsum("bnst,btnd->bsnd", p.double(),
                                v.double()).to(q.dtype)
        return torch.einsum("bnst,btnd->bsnd", p, v)
    return fn


def _extend_apart(acc, pv=True):
    two_block = _apart(acc, pv)

    def fn(q, kp, vp, kt, vt, bias, kp_scale=None, vp_scale=None):
        t = kp.shape[1]
        return two_block(q, kp, vp, bias[..., :t], kt, vt, bias[..., t:])
    return fn


TREE = (decoder.grouped_attention_two_block, decoder.cache_extend_attention)
EXTEND_VARIANTS = {**{m: _extend(m) for m in ("float32", "f64_sums",
                                               "float64")},
                   "fp32_apart": _extend_apart(torch.float32),
                   "f64_qk": _extend_apart(torch.float64, pv=False),
                   "this_tree": TREE[1]}


def use(name):
    decoder.grouped_attention_two_block = (
        TREE[0] if name == "this_tree" else VARIANTS[name])


def padded(rows, width, batch=32):
    ids = np.zeros((batch, width), np.int64)
    mask = np.zeros((batch, width), np.int32)
    for i, r in enumerate((rows + rows)[:batch]):
        ids[i, :len(r)] = r
        mask[i, :len(r)] = 1
    return (torch.as_tensor(ids, device="cuda"),
            torch.as_tensor(mask, device="cuda"))


SLOTS = (112, 128, 256, 448)


def padding_rows(w, cfg, names):
    """Rows (of 31) whose scores equal the 112-slot cache's, per variant,
    cache and 5-step chunk."""
    rng = np.random.default_rng(0)
    rows = [rng.integers(3, cfg.vocab_size, int(n)).tolist()
            for n in rng.integers(90, 113, 31)]
    out = {}
    for name in names:
        use(name)
        got = {}
        for slots in SLOTS:
            ids, mask = padded(rows, slots)
            last, cache = decoder.prefill(w, cfg, ids, mask, cache_len=slots)
            lens = mask.sum(-1)
            _, s1, cache, prev, _ = decoder.decode_steps(
                w, cfg, cache, last, lens, 0, 5, None, None, with_scores=True)
            _, s2, *_ = decoder.decode_steps(
                w, cfg, cache, prev, lens, 5, 5, None, None,
                with_scores=True)
            got[slots] = (s1[:31], s2[:31])
            if slots == SLOTS[-1]:
                # the slot ring's compaction: valid slots first, the axis
                # cut to 128 (the prompts' 112 and the chunk's 5 fit)
                _, s2c, *_ = decoder.decode_steps(
                    w, cfg, slots_mod._compact_cache_slots(cache, 128), prev,
                    lens, 5, 5, None, None, with_scores=True)
                got["448c"] = (s1[:31], s2c[:31])
        out[name] = {str(sl): [int((a == b).flatten(1).all(-1).sum())
                               for a, b in zip(got[112], got[sl])]
                     for sl in SLOTS[1:] + ("448c",)}
    return out


def extend_rows(w, cfg):
    """Rows (of 31) whose suffix-extension logits equal between prefix
    caches of 112 and 128 slots, per extension attention."""
    rng = np.random.default_rng(2)
    rows = [rng.integers(3, cfg.vocab_size, int(n)).tolist()
            for n in rng.integers(90, 113, 31)]
    suffix = torch.as_tensor(rng.integers(3, cfg.vocab_size, (32, 35)),
                             device="cuda")
    smask = torch.ones_like(suffix, dtype=torch.int32)
    out = {}
    for name, fn in EXTEND_VARIANTS.items():
        decoder.cache_extend_attention = fn
        got = []
        for slots in (112, 128):
            ids, mask = padded(rows, slots)
            _, cache = decoder.prefill(w, cfg, ids, mask, cache_len=slots)
            got.append(decoder.extend_prefill(w, cfg, cache, suffix, smask,
                                              mask.sum(-1))[0][:31])
        out[name] = int((got[0] == got[1]).all(-1).sum())
    decoder.cache_extend_attention = TREE[1]
    return out


def chunk_ms(w, cfg, names, buckets=(64, 448)):
    res = {}
    for bucket in buckets:
        rng = np.random.default_rng(1)
        ids, mask = padded([rng.integers(3, cfg.vocab_size,
                                         bucket - 8).tolist()
                            for _ in range(32)], bucket)
        last, cache = decoder.prefill(w, cfg, ids, mask, cache_len=bucket)
        tgt = torch.zeros((32, 2), dtype=torch.int64, device="cuda")
        times = {n: [] for n in names}
        for name in list(names) + list(reversed(names)):
            use(name)
            times[name].append(cs.time_ms(lambda: decoder.decode_steps(
                w, cfg, cache, last, mask.sum(-1), 0, 10, None, None,
                with_scores="reduced", target_ids=tgt), iters=3, warmup=1))
        res[str(bucket)] = times
        del cache
    return res


def attention_us(cfg, names, buckets=(64, 448)):
    gen = torch.Generator(device="cuda").manual_seed(3)
    n, g, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    res = {}
    for bucket in buckets:
        def t(*shape):
            return torch.randn(*shape, device="cuda", generator=gen).to(
                torch.bfloat16)
        q, kp, vp = t(32, 1, n, d), t(32, bucket, g, d), t(32, bucket, g, d)
        kt, vt = t(32, 5, g, d), t(32, 5, g, d)
        bias_p = torch.zeros(32, 1, 1, bucket, device="cuda")
        bias_t = torch.zeros(32, 1, 1, 5, device="cuda")
        fns = {**VARIANTS, "this_tree": TREE[0]}
        res[str(bucket)] = {
            name: 1e3 * cs.time_ms(lambda: fns[name](
                q, kp, vp, bias_p, kt, vt, bias_t), iters=20)
            for name in names}
    return res


def ring_rows_per_s(w, cfg):
    """Ring route rows/s, rings padded to capacity (this tree) against
    rings shrunk to the slice menu, in turns A B B A."""
    tok = cs._id_tokenizer(cfg.vocab_size)
    prompts = cs._prompts(0, tok, cs.POOL_PROMPTS)
    base = emod.EngineConfig(decode_completions=False, batch_size=cs.BATCH,
                             phase2_pool_target=cs.POOL_TARGET)
    batches = list(batching.batches_for_prompts(
        prompts, cs.BATCH, base.buckets, pad_id=tok.pad_token_id,
        length_sorted=True))
    targets = cs._pool_targets(0, w, cfg, batches, cs.POOL_PROMPTS)
    full = emod._full_ring
    menus = {"capacity": full,
             "shrinking": lambda cap: (lambda n: emod._pad_slice(n, max(n, 1)))}
    out = {k: [] for k in menus}
    from llm_interpretation_replication_tpu_torch.utils import telemetry
    for name in ("capacity", "shrinking", "shrinking", "capacity"):
        emod._full_ring = menus[name]
        eng = emod.ScoringEngine("falcon", cfg, w, tok, engine_config=base,
                                 device="cuda")
        eng.score_prompts(prompts[:cs.BATCH], targets[:cs.BATCH])
        torch.cuda.synchronize()
        snap = telemetry.counters()
        t0 = time.perf_counter()
        eng.score_prompts(prompts, targets)
        torch.cuda.synchronize()
        out[name].append(dict(
            rows_per_s=cs.POOL_PROMPTS / (time.perf_counter() - t0),
            completion_cache_bytes_freed=telemetry.counters_since(snap).get(
                "completion_cache_bytes_freed", 0)))
        eng.close(release_params=False)
    emod._full_ring = full
    return out


ROSTER = {
    "falcon-7b": None, "pythia-6.9b": cs.PYTHIA_6_9B,
    "stablelm-alpha-7b": cs.STABLELM_ALPHA_7B,
    "redpajama-7b": cs.REDPAJAMA_7B, "bloom-7b1": cs.BLOOM_7B1,
    "mistral-7b-v0.2": cs.MISTRAL_7B_V02, "qwen-7b-chat": cs.QWEN_7B_CHAT,
    "baichuan2-7b-chat": cs.BAICHUAN2_7B_CHAT,
    "opt-iml-1.3b": cs.OPT_IML_1_3B, "h2ogpt-12b": cs.H2OGPT_12B,
    "mistral-7b-v0.3": cs.MISTRAL_7B_V03,
}
ROWS = (1, 8, 16, 32, 48, 64, 96)


def family_weights(label, cfg, device="cuda"):
    """Random bf16 weights (seed 0): Falcon's from ``random_params``, the
    others' as a published checkpoint read through the port's converter
    (as the smoke's families phase makes them)."""
    if ROSTER[label] is None:
        return convert.random_params(cfg, seed=0, device=device, dtype="bf16")
    family = cs._family_config(ROSTER[label], 1)[0]
    sd = cs._hf_state_dict(family, cfg, 0, device, torch.bfloat16)
    tree = convert.CONVERTERS[family](sd.__getitem__, cfg)
    del sd
    return decoder.DecoderWeights(cfg, tree)


def family_cfg(label, layers=None):
    """The family's DecoderConfig, at ``layers`` layers or its published
    depth."""
    if ROSTER[label] is None:
        return mconfig.DecoderConfig(**{
            **mconfig.FALCON_7B_GEOMETRY,
            "num_layers": layers or mconfig.FALCON_7B_GEOMETRY["num_layers"]},
            attention_impl="flash")
    return cs._family_config(ROSTER[label], layers)[1]


def rows_padded(x, w, rows=64):
    """``x @ w`` with ``x``'s rows padded to ``rows`` (zeros) and cut back:
    the padding this probe tried for products whose reduction is longer
    than their output."""
    m, k = x.shape
    if m >= rows or k <= w.shape[-1]:
        return x @ w
    return (torch.nn.functional.pad(x, (0, 0, 0, rows - m)) @ w)[:m]


def product_rows():
    """Per roster family: for each bf16 projection shape (K, N) of its
    layers, at each of ROWS rows, whether every row equals a 128-row
    product's, plain and through ``rows_padded``; the same for the
    float32 unembedding (``decoder._matmul_f32``, [H, V])."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    res, seen = {}, {}

    def rand(*shape):
        return torch.randn(*shape, device="cuda", generator=gen)

    for label in ROSTER:
        cfg = family_cfg(label, 1)
        w = convert.random_params(cfg, seed=0, device="cuda", dtype="bf16")
        shapes = sorted({tuple(t.shape[1:]) for t in _leaves(w.tree()["layers"])
                         if t.dim() == 3 and t.dtype == torch.bfloat16})
        del w
        for k, n in shapes:
            if (k, n) not in seen:
                wt = (rand(k, n) / k ** 0.5).to(torch.bfloat16)
                x = rand(128, k).to(torch.bfloat16)
                full = x @ wt
                seen[(k, n)] = {
                    "plain": [bool((x[:m] @ wt == full[:m]).all())
                              for m in ROWS],
                    "padded": [bool((rows_padded(x[:m], wt)
                                     == full[:m]).all()) for m in ROWS]}
                del wt, x, full
            res.setdefault(label, {})[f"{k}x{n}"] = seen[(k, n)]
        head = (cfg.hidden_size, cfg.vocab_size)
        if head not in seen:
            wt = (rand(*head) / head[0] ** 0.5).to(torch.bfloat16)
            x = rand(128, head[0]).to(torch.bfloat16)
            full = decoder._matmul_f32(x, wt)
            seen[head] = {"f32": [bool((decoder._matmul_f32(x[:m], wt)
                                        == full[:m]).all()) for m in ROWS]}
            del wt, x, full
        res[label][f"head {head[0]}x{head[1]}"] = seen[head]
        torch.cuda.empty_cache()
    return res


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        elif isinstance(v, torch.Tensor):
            yield v


def main():
    if not torch.cuda.is_available():
        print("decode_layout_probe: needs a CUDA device", file=sys.stderr)
        return 2
    cs.build_phase(_build, attn)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    args = dict(a.lstrip("-").split("=", 1) for a in sys.argv[1:])
    names = args.get("variants", ",".join([*VARIANTS, "this_tree"])).split(",")
    sections = set(args.get("sections", "padding,timing,extend,ring,"
                            "products").split(","))
    out = {"card": card, "torch": torch.__version__, "families": {}}
    for label in ("falcon-7b", "bloom-7b1", "mistral-7b-v0.2"):
        t0 = time.perf_counter()
        cfg = family_cfg(label)
        w = family_weights(label, cfg)
        fam = {"layers": cfg.num_layers, "heads": [cfg.num_heads,
                                                   cfg.num_kv_heads,
                                                   cfg.head_dim]}
        if "padding" in sections:
            fam["padding_rows_equal_of_31"] = padding_rows(w, cfg, names)
        if "timing" in sections:
            fam["chunk_ms"] = chunk_ms(w, cfg, names)
            fam["attention_us"] = attention_us(cfg, names)
        use("this_tree")
        if label == "falcon-7b" and "extend" in sections:
            fam["extend_rows_equal_of_31"] = extend_rows(w, cfg)
        if label == "falcon-7b" and "ring" in sections:
            fam["ring_rows_per_s"] = ring_rows_per_s(w, cfg)
        fam["seconds"] = time.perf_counter() - t0
        out["families"][label] = fam
        print(label, json.dumps(fam), flush=True)
        del w
        torch.cuda.empty_cache()
    if "products" in sections:
        out["product_rows_equal_to_128_rows"] = {"rows": ROWS,
                                                 **product_rows()}
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "decode_layout_probe.json"),
              "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
