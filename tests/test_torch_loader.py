"""The port's snapshot loader (``runtime.loader``, ``models.convert.
convert_falcon``, ``models.config.from_hf_config``) against the JAX
package's loader and the Hugging Face model itself.

Tiny Falcon snapshots are written here with ``transformers``'
``FalconForCausalLM`` (as ``tests/test_model_parity.py`` builds one): the
old multi-query layout (Falcon-7B's) and the new grouped one, as one
safetensors file, as shards with an index, and as ``pytorch_model.bin``.
Classes: the port's weights equal the JAX loader's (carried over by
``params_from_jax``) exactly, int8 codes and scales included; logits match
the HF model at atol 2e-3 on a ragged batch (``tests/test_model_parity.py``);
a bf16 snapshot loads bf16 bit for bit.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from llm_interpretation_replication_tpu.models import config as jconfig
from llm_interpretation_replication_tpu.runtime import loader as jloader
from llm_interpretation_replication_tpu_torch.models import config as tconfig
from llm_interpretation_replication_tpu_torch.models import convert
from llm_interpretation_replication_tpu_torch.models import decoder as tdec
from llm_interpretation_replication_tpu_torch.runtime import loader
import chip_smoke
from test_torch_slots import one_torch_thread  # noqa: F401

VOCAB = 128
HF_ATOL = 2e-3
LAYOUTS = {
    # Falcon-7B's: multi-query, parallel attention, one shared layernorm
    "mqa": dict(num_attention_heads=4, multi_query=True,
                new_decoder_architecture=False),
    # Falcon-40B's: grouped K/V, two layernorms
    "grouped": dict(num_attention_heads=4, num_kv_heads=2,
                    new_decoder_architecture=True),
}
FORMATS = {"safetensors": dict(safe_serialization=True),
           "sharded": dict(safe_serialization=True, max_shard_size="40KB"),
           "bin": dict(safe_serialization=False)}


def _hf_model(layout):
    from transformers import FalconConfig, FalconForCausalLM

    hf_config = FalconConfig(vocab_size=VOCAB, hidden_size=32,
                             num_hidden_layers=3, parallel_attn=True,
                             bias=False, alibi=False, **LAYOUTS[layout])
    torch.manual_seed(2)
    return FalconForCausalLM(hf_config).eval()


@pytest.fixture(scope="module")
def snapshots(tmp_path_factory):
    out = {}
    for layout in LAYOUTS:
        model = _hf_model(layout)
        for fmt, kw in FORMATS.items():
            path = tmp_path_factory.mktemp(f"{layout}_{fmt}")
            model.save_pretrained(str(path), **kw)
            out[layout, fmt] = (str(path), model)
    return out


def _jax_weights(path, tcfg, quant="none"):
    _, _, params = jloader.load_model(path, dtype=jnp.float32, quant=quant)
    params_np = jax.tree_util.tree_map(np.asarray, params)
    return convert.params_from_jax(params_np, tcfg, device="cpu", dtype="fp32")


def _assert_same_weights(got, ref):
    a, b = dict(tdec._flatten(got.tree())), dict(tdec._flatten(ref.tree()))
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0, msg=str(k))


def _batch(seed=0, batch=3, seq=12):
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, VOCAB, size=(batch, seq))
    mask = np.ones((batch, seq), np.int64)
    for r, pad in ((1, 3), (2, 5)):
        mask[r, seq - pad:] = 0
        ids[r, seq - pad:] = 0
    return ids, mask


@pytest.mark.parametrize("fmt", list(FORMATS))
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_load_model_matches_jax_loader_and_hf(snapshots, layout, fmt):
    path, model = snapshots[layout, fmt]
    family, cfg, weights = loader.load_model(path, dtype="fp32", device="cpu")
    assert family == "falcon"
    assert cfg.num_kv_heads == (1 if layout == "mqa" else 2)
    assert cfg.shared_layernorm == (layout == "mqa")
    _assert_same_weights(weights, _jax_weights(path, cfg))
    ids, mask = _batch()
    got = tdec.forward(weights, cfg, torch.from_numpy(ids),
                       torch.from_numpy(mask)).numpy()
    with torch.no_grad():
        ref = model(input_ids=torch.from_numpy(ids),
                    attention_mask=torch.from_numpy(mask)).logits.numpy()
    real = mask.astype(bool)
    np.testing.assert_allclose(got[real], ref[real], atol=HF_ATOL, rtol=1e-3)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_int8_codes_and_scales_match_jax_loader(snapshots, layout):
    path, _ = snapshots[layout, "safetensors"]
    _, cfg, weights = loader.load_model(path, dtype="fp32", quant="int8",
                                        device="cpu")
    ref = _jax_weights(path, cfg, quant="int8")
    _assert_same_weights(weights, ref)
    assert weights.tree()["layers"]["mlp"]["wi"].dtype == torch.int8


def test_bf16_snapshot_loads_bit_for_bit(tmp_path):
    """A bf16 snapshot stays bf16 from file to weights, and its tensors
    come back as written."""
    model = _hf_model("mqa").to(torch.bfloat16)
    model.save_pretrained(str(tmp_path), safe_serialization=True)
    ckpt = loader.CheckpointDir(str(tmp_path))
    sd = model.state_dict()
    names = loader.read_safetensors_header(
        str(tmp_path / "model.safetensors"))[0]
    assert names
    for name in names:
        t = ckpt.get(name)
        assert t.dtype == torch.bfloat16
        assert torch.equal(t, sd[name])
    _, cfg, weights = loader.load_model(str(tmp_path), dtype="bf16",
                                        device="cpu")
    tree = weights.tree()
    assert all(t.dtype == torch.bfloat16 for _, t in tdec._flatten(tree))
    assert torch.equal(tree["embed"]["tokens"],
                       sd["transformer.word_embeddings.weight"])


def test_smoke_snapshot_writer_round_trips(tmp_path):
    """``chip_smoke.py``'s snapshot (its safetensors writer, Falcon-7B's
    QKV layout, legacy config keys) loads back through the port's loader
    bit for bit, and the ``safetensors`` package reads the same tensors."""
    from safetensors.torch import load_file

    cfg = tconfig.DecoderConfig(**{**tconfig.FLAGSHIP_SMALL_GEOMETRY,
                                   "num_layers": 2, "vocab_size": 96,
                                   "max_position_embeddings": 2048})
    weights = convert.random_params(cfg, seed=4, device="cpu", dtype="bf16")
    sd = chip_smoke._falcon_state_dict(weights.tree(), cfg)
    chip_smoke._write_safetensors(str(tmp_path / "model.safetensors"), sd)
    with open(tmp_path / "config.json", "w") as f:
        json.dump(chip_smoke._falcon_config_json(cfg), f)
    read = load_file(str(tmp_path / "model.safetensors"))
    assert read.keys() == sd.keys()
    assert all(torch.equal(read[k], sd[k]) for k in sd)
    family, lcfg, loaded = loader.load_model(str(tmp_path), dtype="bf16",
                                             device="cpu")
    assert (family, dataclasses.replace(lcfg, fused_qkv=False)) == \
        ("falcon", cfg)
    _assert_same_weights(loaded, weights)
    jcfg = jloader.load_hf_config(str(tmp_path))
    assert vars(loader.load_hf_config(str(tmp_path))) == vars(jcfg)


def test_load_hf_config_aliases_legacy_keys(tmp_path):
    raw = {"model_type": "RefinedWebModel", "n_layer": 2, "n_head": 4,
           "n_head_kv": 1, "n_embed": 32, "vocab_size": 64,
           "feed_forward_proj": "gated-gelu"}
    (tmp_path / "config.json").write_text(json.dumps(raw))
    got = loader.load_hf_config(str(tmp_path))
    assert vars(got) == vars(jloader.load_hf_config(str(tmp_path)))
    assert got.num_hidden_layers == 2 and got.hidden_size == 32
    family, cfg = tconfig.from_hf_config(got)
    assert family == "falcon" and cfg.num_layers == 2


@pytest.mark.parametrize("model_type,raises", [
    ("llama", "no weights"), ("gpt_neox", "no weights"),
    ("mpt", "no weights"), (None, "unsupported model_type"),
])
def test_other_model_types_raise(tmp_path, model_type, raises):
    """Every model type of the JAX package is ported: ``llama``,
    ``gpt_neox`` and ``mpt`` (one of the last types ported) translate and
    the loader goes on to look for weights, while a snapshot without a
    known model type raises the JAX package's ``ValueError``, word for
    word."""
    import types

    if model_type is None:
        (tmp_path / "config.json").write_text(json.dumps({"hidden_size": 32}))
        with pytest.raises(ValueError, match=raises) as got:
            loader.load_model(str(tmp_path), device="cpu")
        with pytest.raises(ValueError) as ref:
            jconfig.from_hf_config(types.SimpleNamespace(hidden_size=32))
        assert str(got.value) == str(ref.value)
        return
    (tmp_path / "config.json").write_text(json.dumps(dict(
        model_type=model_type, vocab_size=VOCAB, hidden_size=32,
        num_hidden_layers=2, num_attention_heads=4, intermediate_size=64,
        max_position_embeddings=64, layer_norm_eps=1e-5,
        rms_norm_eps=1e-5, hidden_act="silu", d_model=32, n_heads=4,
        n_layers=2)))
    with pytest.raises(FileNotFoundError, match=raises):
        loader.load_model(str(tmp_path), device="cpu")


def test_loader_errors(tmp_path, snapshots):
    with pytest.raises(FileNotFoundError):
        loader.CheckpointDir(str(tmp_path))
    path, _ = snapshots["mqa", "safetensors"]
    with pytest.raises(ValueError, match="quant"):
        loader.load_model(path, quant="int4", device="cpu")
    with pytest.raises(ValueError, match="attention_impl"):
        loader.load_model(path, attention_impl="paged", device="cpu")
    with pytest.raises(KeyError):
        loader.CheckpointDir(path).get("no.such.tensor")
    _, cfg, _ = loader.load_model(path, attention_impl="flash", device="cpu",
                                  dtype="fp32")
    assert cfg.attention_impl == "flash"
    # an explicit flash on a model the kernel cannot take is refused, not
    # run on the plain path
    with open(f"{path}/config.json") as f:
        hf = json.load(f)
    alibi = tmp_path / "alibi"
    alibi.mkdir()
    (alibi / "config.json").write_text(json.dumps(dict(hf, alibi=True)))
    with pytest.raises(ValueError, match="ALiBi"):
        loader.load_model(str(alibi), attention_impl="flash", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            loader.load_model(path)
