"""Pretrained weights from HuggingFace: the port of
``tensorflow_examples_tpu/models/hf_import.py`` (``import_gpt2`` and
``import_bert``).

:func:`import_gpt2` maps an HF ``GPT2LMHeadModel`` state dict onto the
reference's param tree (the ``models/convert.py`` layout), from a model
object or from a local directory. HF's ``Conv1D`` stores weights [in,
out], the flax ``Dense`` layout, so only the head reshapes are needed.
A directory is read without ``transformers``: ``config.json`` for the
widths, then ``model.safetensors`` (an 8-byte little-endian header
length, a JSON header of dtype, shape and byte offsets a tensor, raw
bytes: numpy reads it) or ``pytorch_model.bin`` (``torch.load`` with
``weights_only=True``). Keys may carry the ``transformer.`` prefix of a
saved ``GPT2LMHeadModel`` or not (a saved ``GPT2Model``); the tied
``lm_head.weight`` and the attention mask buffers are ignored.
:func:`import_bert` does the same for an HF ``BertModel`` or
``BertForSequenceClassification``: torch ``Linear`` weights [out, in]
are transposed to flax's [in, out], and the three QKV Linears stack into
the ``[d, 3, H, hd]`` kernel.
:func:`export_gpt2` writes a param tree the other way, as a directory
that both :func:`import_gpt2` and ``GPT2LMHeadModel.from_pretrained``
load.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Any, Mapping

import numpy as np
import torch

from tensorflow_examples_torch.models.bert import BertConfig
from tensorflow_examples_torch.models.transformer import TransformerConfig

_ST_DTYPES = {"F64": np.float64, "F32": np.float32, "F16": np.float16, "I64": np.int64,
              "I32": np.int32, "I16": np.int16, "I8": np.int8, "U8": np.uint8, "BOOL": np.bool_}
_PREFIX = "transformer."


def read_safetensors(path: str) -> dict[str, np.ndarray]:
    """Every tensor of a ``.safetensors`` file as a numpy array (bf16 as
    f32, exactly)."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
    data = np.memmap(path, dtype=np.uint8, mode="r", offset=8 + n)
    out = {}
    for name, meta in header.items():
        if name == "__metadata__":
            continue
        start, end = meta["data_offsets"]
        raw = np.asarray(data[start:end])
        if meta["dtype"] == "BF16":
            arr = (raw.view(np.uint16).astype(np.uint32) << 16).view(np.float32)
        elif meta["dtype"] in _ST_DTYPES:
            arr = raw.view(_ST_DTYPES[meta["dtype"]])
        else:
            raise ValueError(f"{path}: tensor {name!r} has dtype {meta['dtype']}, not one of "
                             f"BF16, {', '.join(_ST_DTYPES)}")
        out[name] = arr.reshape(meta["shape"])
    return out


def write_safetensors(path: str, tensors: Mapping[str, np.ndarray]) -> None:
    """Write ``tensors`` (numpy arrays of a dtype in ``_ST_DTYPES``) as one
    ``.safetensors`` file, metadata format "pt"."""
    names = {np.dtype(v): k for k, v in _ST_DTYPES.items()}
    header, offset, blobs = {"__metadata__": {"format": "pt"}}, 0, []
    for name, arr in tensors.items():
        arr = np.ascontiguousarray(arr)
        blob = arr.tobytes()
        header[name] = {"dtype": names[arr.dtype], "shape": list(arr.shape),
                        "data_offsets": [offset, offset + len(blob)]}
        offset += len(blob)
        blobs.append(blob)
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)  # the data starts 8-byte aligned
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for blob in blobs:
            f.write(blob)


def _load_directory(path: str) -> tuple[dict, dict[str, np.ndarray]]:
    """(config.json, state dict) of a local ``from_pretrained`` directory."""
    with open(os.path.join(path, "config.json")) as f:
        hfc = json.load(f)
    st, binary = os.path.join(path, "model.safetensors"), os.path.join(path, "pytorch_model.bin")
    if os.path.exists(st):
        sd = read_safetensors(st)
    elif os.path.exists(binary):
        sd = {k: v.float().numpy() if v.is_floating_point() else v.numpy()
              for k, v in torch.load(binary, map_location="cpu", weights_only=True).items()}
    else:
        raise FileNotFoundError(f"{path} holds neither model.safetensors nor pytorch_model.bin")
    return hfc, sd


def _np(t) -> np.ndarray:
    return t.detach().float().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def import_gpt2(hf_model_or_path: Any,
                cfg: TransformerConfig | None = None) -> tuple[TransformerConfig, dict]:
    """An HF ``GPT2LMHeadModel`` (or a local directory of one) as
    ``(config, params)``: the reference's nested param tree of numpy
    arrays. Without ``cfg`` the widths come from the HF config."""
    if isinstance(hf_model_or_path, (str, os.PathLike)):
        hfc, sd = _load_directory(os.fspath(hf_model_or_path))
    else:
        hfc = hf_model_or_path.config.to_dict()
        sd = {k: _np(v) for k, v in hf_model_or_path.state_dict().items()}
    sd = {k[len(_PREFIX):] if k.startswith(_PREFIX) else k: v for k, v in sd.items()}
    if cfg is None:
        cfg = TransformerConfig(vocab_size=hfc["vocab_size"], max_len=hfc["n_positions"],
                                num_layers=hfc["n_layer"], num_heads=hfc["n_head"],
                                d_model=hfc["n_embd"])
    d, h, hd = cfg.d_model, cfg.num_heads, cfg.head_dim

    def ln(prefix):
        return {"scale": sd[f"{prefix}.weight"], "bias": sd[f"{prefix}.bias"]}

    params: dict = {"wte": {"embedding": sd["wte.weight"]},
                    "wpe": {"embedding": sd["wpe.weight"]}, "ln_f": ln("ln_f")}
    for i in range(cfg.num_layers):
        p = f"h.{i}"
        params[f"h_{i}"] = {
            "ln_1": ln(f"{p}.ln_1"),
            "ln_2": ln(f"{p}.ln_2"),
            "attn": {
                "qkv": {"kernel": sd[f"{p}.attn.c_attn.weight"].reshape(d, 3, h, hd),
                        "bias": sd[f"{p}.attn.c_attn.bias"].reshape(3, h, hd)},
                "proj": {"kernel": sd[f"{p}.attn.c_proj.weight"].reshape(h, hd, d),
                         "bias": sd[f"{p}.attn.c_proj.bias"]},
            },
            "mlp_fc": {"kernel": sd[f"{p}.mlp.c_fc.weight"], "bias": sd[f"{p}.mlp.c_fc.bias"]},
            "mlp_proj": {"kernel": sd[f"{p}.mlp.c_proj.weight"],
                         "bias": sd[f"{p}.mlp.c_proj.bias"]},
        }
    return cfg, params


def import_bert(hf_model_or_path: Any) -> tuple[BertConfig, dict]:
    """An HF ``BertModel`` or ``BertForSequenceClassification`` (or a
    local directory of one) as ``(config, params)``: the reference's
    ``BertClassifier`` tree of numpy arrays. ``classifier`` is there only
    when the checkpoint has one; the caller keeps its fresh head
    otherwise (``workloads/bert_glue.py``)."""
    if isinstance(hf_model_or_path, (str, os.PathLike)):
        hfc, sd = _load_directory(os.fspath(hf_model_or_path))
    else:
        hfc = hf_model_or_path.config.to_dict()
        sd = {k: _np(v) for k, v in hf_model_or_path.state_dict().items()}
    cfg = BertConfig(vocab_size=hfc["vocab_size"], max_len=hfc["max_position_embeddings"],
                     type_vocab_size=hfc["type_vocab_size"],
                     num_layers=hfc["num_hidden_layers"], num_heads=hfc["num_attention_heads"],
                     d_model=hfc["hidden_size"], d_ff=hfc["intermediate_size"],
                     layer_norm_eps=hfc["layer_norm_eps"])
    d, h, hd = cfg.d_model, cfg.num_heads, cfg.head_dim
    pre = "bert." if any(k.startswith("bert.") for k in sd) else ""

    def lin(prefix):  # torch Linear [out, in] -> flax Dense [in, out]
        return {"kernel": sd[f"{prefix}.weight"].T, "bias": sd[f"{prefix}.bias"]}

    def ln(prefix):
        return {"scale": sd[f"{prefix}.weight"], "bias": sd[f"{prefix}.bias"]}

    emb = f"{pre}embeddings"
    bert: dict = {
        "word_embeddings": {"embedding": sd[f"{emb}.word_embeddings.weight"]},
        "position_embeddings": {"embedding": sd[f"{emb}.position_embeddings.weight"]},
        "token_type_embeddings": {"embedding": sd[f"{emb}.token_type_embeddings.weight"]},
        "embeddings_ln": ln(f"{emb}.LayerNorm"),
        "pooler": lin(f"{pre}pooler.dense"),
    }
    for i in range(cfg.num_layers):
        p = f"{pre}encoder.layer.{i}"
        qkv = ("query", "key", "value")
        bert[f"layer_{i}"] = {
            "attn_qkv": {
                "kernel": np.stack([sd[f"{p}.attention.self.{n}.weight"].T.reshape(d, h, hd)
                                    for n in qkv], axis=1),
                "bias": np.stack([sd[f"{p}.attention.self.{n}.bias"].reshape(h, hd)
                                  for n in qkv], axis=0),
            },
            "attn_proj": {"kernel": sd[f"{p}.attention.output.dense.weight"].T.reshape(h, hd, d),
                          "bias": sd[f"{p}.attention.output.dense.bias"]},
            "attn_ln": ln(f"{p}.attention.output.LayerNorm"),
            "ffn_in": lin(f"{p}.intermediate.dense"),
            "ffn_out": lin(f"{p}.output.dense"),
            "ffn_ln": ln(f"{p}.output.LayerNorm"),
        }
    params: dict = {"bert": bert}
    if "classifier.weight" in sd:
        params["classifier"] = lin("classifier")
    return cfg, params


def export_gpt2(params: Mapping, cfg: TransformerConfig, path: str) -> None:
    """Write a dense GPT-2 param tree (reference layout, nested dicts of
    arrays or tensors) as an HF directory: ``config.json`` and
    ``model.safetensors`` (f32, ``transformer.``-prefixed names)."""
    d, p = cfg.d_model, params
    sd = {"wte.weight": p["wte"]["embedding"], "wpe.weight": p["wpe"]["embedding"],
          "ln_f.weight": p["ln_f"]["scale"], "ln_f.bias": p["ln_f"]["bias"]}
    for i in range(cfg.num_layers):
        blk, hf = p[f"h_{i}"], f"h.{i}"
        sd.update({
            f"{hf}.ln_1.weight": blk["ln_1"]["scale"], f"{hf}.ln_1.bias": blk["ln_1"]["bias"],
            f"{hf}.ln_2.weight": blk["ln_2"]["scale"], f"{hf}.ln_2.bias": blk["ln_2"]["bias"],
            f"{hf}.attn.c_attn.weight": _np(blk["attn"]["qkv"]["kernel"]).reshape(d, 3 * d),
            f"{hf}.attn.c_attn.bias": _np(blk["attn"]["qkv"]["bias"]).reshape(3 * d),
            f"{hf}.attn.c_proj.weight": _np(blk["attn"]["proj"]["kernel"]).reshape(d, d),
            f"{hf}.attn.c_proj.bias": blk["attn"]["proj"]["bias"],
            f"{hf}.mlp.c_fc.weight": blk["mlp_fc"]["kernel"],
            f"{hf}.mlp.c_fc.bias": blk["mlp_fc"]["bias"],
            f"{hf}.mlp.c_proj.weight": blk["mlp_proj"]["kernel"],
            f"{hf}.mlp.c_proj.bias": blk["mlp_proj"]["bias"],
        })
    os.makedirs(path, exist_ok=True)
    write_safetensors(os.path.join(path, "model.safetensors"),
                      {_PREFIX + k: _np(v).astype(np.float32) for k, v in sd.items()})
    config = {"model_type": "gpt2", "architectures": ["GPT2LMHeadModel"],
              "vocab_size": cfg.vocab_size, "n_positions": cfg.max_len, "n_embd": d,
              "n_layer": cfg.num_layers, "n_head": cfg.num_heads, "n_inner": cfg.ff_dim,
              "activation_function": "gelu_new", "layer_norm_epsilon": 1e-5,
              "resid_pdrop": cfg.dropout, "embd_pdrop": cfg.dropout, "attn_pdrop": 0.0,
              "tie_word_embeddings": True}
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(config, f, indent=1)
