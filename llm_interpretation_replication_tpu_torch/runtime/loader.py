"""Checkpoint loading: a local HF snapshot -> (family, config, weights) on
the engine's device (a copy of ``runtime/loader.py``'s ``load_hf_config``,
``CheckpointDir``, ``load_model`` and the K-head persistence
``snapshot_fingerprint``, ``save_k_head``, ``load_k_head`` and
``attach_k_head``; ``load_tokenizer`` is ``utils.tokenizer.load_tokenizer``).

Weights are read from ``*.safetensors`` (one file, or shards named by
``model.safetensors.index.json``) with the port's own reader of the format,
or from ``pytorch_model.bin`` (or its shards) through
``torch.load(weights_only=True)``.  Each tensor keeps its stored dtype on
the host (bf16 stays bf16: 7B weights never pass through float32 there),
moves to the device as it is read, and is converted there.  Nothing is
downloaded: the snapshot is a local directory.
"""

from __future__ import annotations

import dataclasses
import json
import os
import struct
import types
import warnings
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..device import DEFAULT_DEVICE, resolve_device, resolve_dtype
from ..models import config as mcfg
from ..models import convert as mconvert
from ..models.decoder import DecoderWeights
from ..models.t5 import T5Weights
from ..ops import quant as qops
from ..utils.tokenizer import load_tokenizer

__all__ = ["CheckpointDir", "K_HEAD_FILENAME", "attach_k_head",
           "load_hf_config", "load_k_head", "load_model", "load_tokenizer",
           "read_safetensors_header", "save_k_head", "snapshot_fingerprint"]

#: safetensors dtype -> (numpy storage dtype, torch dtype it is viewed as)
_ST_DTYPES = {
    "BF16": (np.int16, torch.bfloat16),
    "F16": (np.float16, torch.float16),
    "F32": (np.float32, torch.float32),
}


def read_safetensors_header(fname: str) -> Tuple[Dict, int]:
    """(header, byte offset of the data buffer) of a safetensors file: an
    8-byte little-endian header length, a JSON header mapping each tensor
    name to its dtype, shape and ``data_offsets`` into the buffer that
    follows (``__metadata__`` dropped)."""
    with open(fname, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
    header.pop("__metadata__", None)
    return header, 8 + n


class _SafetensorsFile:
    """Tensors of one safetensors file, read through a copy-on-write
    memory map: a tensor's bytes are read when it is used."""

    def __init__(self, fname: str):
        self.header, self.start = read_safetensors_header(fname)
        self.mm = np.memmap(fname, dtype=np.uint8, mode="c")

    def get(self, name: str) -> torch.Tensor:
        info = self.header[name]
        if info["dtype"] not in _ST_DTYPES:
            raise ValueError(f"{name}: safetensors dtype {info['dtype']!r} "
                             f"is not read (one of {sorted(_ST_DTYPES)})")
        np_dtype, dtype = _ST_DTYPES[info["dtype"]]
        b, e = info["data_offsets"]
        raw = self.mm[self.start + b:self.start + e]
        if (self.start + b) % np.dtype(np_dtype).itemsize:
            raw = np.array(raw)                 # a misaligned tensor: copy
        arr = raw.view(np_dtype).reshape(info["shape"])
        return torch.from_numpy(arr).view(dtype)


class CheckpointDir:
    """Random access over a local HF snapshot's weight files: ``get(name)``
    returns one tensor on the host, in its stored dtype."""

    def __init__(self, path: str):
        self.path = path
        self._index: Dict[str, Tuple[str, str]] = {}   # name -> (file, kind)
        self._files: Dict[str, object] = {}
        st_index = os.path.join(path, "model.safetensors.index.json")
        bin_index = os.path.join(path, "pytorch_model.bin.index.json")
        if os.path.exists(st_index):
            self._map_index(st_index, "safetensors")
        elif os.path.exists(os.path.join(path, "model.safetensors")):
            fname = os.path.join(path, "model.safetensors")
            for name in read_safetensors_header(fname)[0]:
                self._index[name] = (fname, "safetensors")
        elif os.path.exists(bin_index):
            self._map_index(bin_index, "torch")
        elif os.path.exists(os.path.join(path, "pytorch_model.bin")):
            fname = os.path.join(path, "pytorch_model.bin")
            for name in self._file(fname, "torch"):
                self._index[name] = (fname, "torch")
        else:
            raise FileNotFoundError(f"no weights found under {path}")

    def _map_index(self, index: str, kind: str) -> None:
        with open(index) as f:
            weight_map = json.load(f)["weight_map"]
        for name, fname in weight_map.items():
            self._index[name] = (os.path.join(self.path, fname), kind)

    def _file(self, fname: str, kind: str):
        handle = self._files.get(fname)
        if handle is None:
            handle = self._files[fname] = (
                _SafetensorsFile(fname) if kind == "safetensors"
                else torch.load(fname, map_location="cpu", weights_only=True))
        return handle

    def get(self, name: str) -> torch.Tensor:
        if name not in self._index:
            raise KeyError(name)
        fname, kind = self._index[name]
        handle = self._file(fname, kind)
        return handle.get(name) if kind == "safetensors" else handle[name]


def load_hf_config(path: str):
    """A snapshot's ``config.json`` as a namespace, without running any
    code of the snapshot; the legacy short keys of the original Falcon
    snapshots (``n_layer``, ``n_head``, ``n_head_kv``, ``n_embed``, ...)
    alias the canonical names."""
    with open(os.path.join(path, "config.json")) as f:
        raw = json.load(f)
    proj = raw.get("feed_forward_proj")
    if proj and "dense_act_fn" not in raw:
        raw["dense_act_fn"] = proj.replace("gated-", "")
        raw["is_gated_act"] = proj.startswith("gated-")
    for legacy, canonical in (
        ("n_layer", "num_hidden_layers"),
        ("n_head", "num_attention_heads"),
        ("n_head_kv", "num_kv_heads"),
        ("n_embed", "hidden_size"),
        ("n_embd", "hidden_size"),
        ("n_positions", "max_position_embeddings"),
    ):
        if legacy in raw and canonical not in raw:
            raw[canonical] = raw[legacy]
    return types.SimpleNamespace(**raw)


def _cast(tree: Dict, dtype: torch.dtype, key: str = "") -> Dict:
    """Every float leaf to ``dtype``, except int8 codes and their float32
    ``*_qscale`` scales."""
    if isinstance(tree, dict):
        return {k: _cast(v, dtype, k) for k, v in tree.items()}
    if tree.dtype == torch.int8 or key.endswith(qops.QSCALE_SUFFIX):
        return tree
    return tree.to(dtype)


def load_model(path: str, dtype="bf16", quant: str = "none",
               attention_impl=None, device=DEFAULT_DEVICE
               ) -> Tuple[str, object, DecoderWeights]:
    """(family, config, weights on ``device``) from a local snapshot dir:
    ``DecoderWeights`` for a decoder-only family, ``T5Weights`` for T5.

    ``quant='int8'`` quantizes the projection weights (w8a8,
    ``ops.quant.quantize_decoder_params``) from the checkpoint's own values
    before the cast to ``dtype``, as the reference's loader does;
    embeddings and norms keep ``dtype``.  ``attention_impl`` sets the
    config's; an explicit ``"flash"`` on a model the kernel cannot take
    (ALiBi, a sliding window) raises ``ValueError`` rather than running the
    plain path.  T5 ignores ``attention_impl``, and under ``quant='int8'``
    warns and loads ``dtype`` weights, as the reference does, so that a
    roster-wide ``--attention-impl flash --quant int8`` runs its T5
    models."""
    dev = resolve_device(device)
    dt = resolve_dtype(dtype)
    if quant not in ("none", "int8"):
        raise ValueError(f"unknown quant mode {quant!r}")
    family, cfg = mcfg.from_hf_config(load_hf_config(path))
    is_t5 = family == "t5"
    if attention_impl and not is_t5:
        cfg = dataclasses.replace(cfg, attention_impl=attention_impl)
    ckpt = CheckpointDir(path)
    tree = mconvert.CONVERTERS[family](lambda name: ckpt.get(name).to(dev), cfg)
    if quant == "int8":
        if is_t5:
            warnings.warn(f"int8 quantization unsupported for T5 family "
                          f"({path}); loading {dtype}")
        else:
            tree = qops.quantize_decoder_params(tree)
    holder = T5Weights if is_t5 else DecoderWeights
    return family, cfg, holder(cfg, _cast(tree, dt))


# -- K-head persistence ---------------------------------------------------------
#
# A distilled K-head (models.decoder.distill_k_head) is a function of the
# weights, decode_k and the distillation sample, so it is kept as
# ``k_head.npz`` beside the snapshot and reloaded when an engine is built
# over the same snapshot.  The fingerprint ties the file to the snapshot's
# config.json bytes and weight-file names and sizes; a head from another
# snapshot is a miss (a stale head could only cost rejected passes).

K_HEAD_FILENAME = "k_head.npz"


def snapshot_fingerprint(path: str) -> str:
    """Content key of a snapshot directory: sha256 over the config.json
    bytes and each weight file's (name, size), reading no weights."""
    import hashlib

    h = hashlib.sha256()
    cfg_path = os.path.join(path, "config.json")
    if os.path.exists(cfg_path):
        with open(cfg_path, "rb") as f:
            h.update(f.read())
    for fname in sorted(os.listdir(path)):
        if fname.endswith((".safetensors", ".bin")):
            h.update(fname.encode())
            h.update(str(os.path.getsize(os.path.join(path, fname))).encode())
    return h.hexdigest()[:16]


def save_k_head(path: str, k_head, decode_k: int,
                fingerprint: Optional[str] = None) -> str:
    """Write a K-head beside the snapshot as float32 numpy (the reference's
    file layout), renamed into place so an interrupted write leaves no torn
    file.  Returns the file's path."""
    fp = fingerprint or snapshot_fingerprint(path)
    out = os.path.join(path, K_HEAD_FILENAME)
    tmp = out + ".tmp.npz"               # savez keeps names ending .npz
    w = k_head["w"].detach().to("cpu", torch.float32).numpy()
    np.savez(tmp, w=w, fingerprint=np.asarray(fp),
             decode_k=np.asarray(int(decode_k)))
    os.replace(tmp, out)
    return out


def load_k_head(path: str, decode_k: int, dtype=None, device="cpu",
                fingerprint: Optional[str] = None):
    """The persisted K-head when one matches (fingerprint, decode_k), as
    ``{"w": tensor}`` in ``dtype`` on ``device``; None on any miss."""
    f = os.path.join(path, K_HEAD_FILENAME)
    if not os.path.exists(f):
        return None
    try:
        with np.load(f, allow_pickle=False) as z:
            if str(z["fingerprint"]) != (fingerprint
                                         or snapshot_fingerprint(path)):
                return None
            if int(z["decode_k"]) != int(decode_k):
                return None
            w = z["w"]
    except (OSError, ValueError, KeyError):
        return None                      # torn or foreign file: a miss
    return {"w": torch.from_numpy(w).to(device=device,
                                        dtype=dtype or torch.float32)}


def attach_k_head(engine, path: str) -> bool:
    """Set ``engine.k_head`` from the snapshot's persisted head when it
    matches the snapshot, ``decode_k`` and the model's width (counted as
    ``k_head_loaded``); False on a miss, when the caller distills."""
    from ..utils.telemetry import record_counter

    decode_k = int(getattr(engine.ecfg, "decode_k", 1))
    if decode_k <= 1:
        return False
    embed = engine.params.tree()["embed"]["tokens"]
    head = load_k_head(path, decode_k, dtype=embed.dtype,
                       device=embed.device)
    if head is None:
        return False
    if int(head["w"].shape[0]) != decode_k - 1 \
            or int(head["w"].shape[1]) != engine.cfg.hidden_size:
        return False
    engine.k_head = head
    record_counter("k_head_loaded")
    return True
