"""HuggingFace checkpoint loading: safetensors → the layer-stacked Llama
layout.

Port of ``kvcached_tpu/models/hf_loader.py`` for the Llama-shaped families
(Llama, Mistral, Qwen2, Qwen3) and Gemma2 (the hybrid family:
:class:`~kvcached_tpu_torch.models.hybrid.HybridConfig`, head_dim read from
the config, 256 for Gemma-2-2B and -9B).  A minimal numpy safetensors reader is
included (header = 8-byte little-endian length + JSON of ``{name: {dtype,
shape, data_offsets}}``); BF16 tensors are widened to float32 exactly by a
bit shift, so no extra package is needed.  Projections are transposed to
input-major (``h @ w``) and stacked on a leading layer axis, the layout of
:class:`~kvcached_tpu_torch.models.llama.LlamaModel`.

Gemma3 checkpoints (unequal layer groups, per-group RoPE, q/k norms), the
transformers tokenizer wrapper and ``engine_from_checkpoint`` are not
ported yet.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from ..device.pool import resolve_device, torch_dtype
from ..logging_utils import get_kvcached_logger
from .hybrid import HybridConfig, HybridModel
from .llama import LlamaConfig, LlamaModel

logger = get_kvcached_logger(__name__)

_ST_DTYPES = {
    "F64": np.float64,
    "F32": np.float32,
    "F16": np.float16,
    "I64": np.int64,
    "I32": np.int32,
    "I16": np.int16,
    "I8": np.int8,
    "U8": np.uint8,
    "BOOL": np.bool_,
}


def read_safetensors(path: str) -> dict[str, np.ndarray]:
    """Minimal reader: whole file into memory, one array per tensor (BF16
    widened to float32)."""
    with open(path, "rb") as f:
        header_len = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(header_len))
        data = f.read()
    out = {}
    for name, meta in header.items():
        if name == "__metadata__":
            continue
        a, b = meta["data_offsets"]
        st = meta["dtype"]
        if st == "BF16":
            raw = np.frombuffer(data[a:b], dtype=np.uint16).astype(np.uint32)
            arr = (raw << 16).view(np.float32)
        elif st in _ST_DTYPES:
            arr = np.frombuffer(data[a:b], dtype=_ST_DTYPES[st])
        else:
            raise ValueError(f"unsupported safetensors dtype {st!r}")
        out[name] = arr.reshape(meta["shape"])
    return out


def _load_all_tensors(ckpt_dir: str) -> dict[str, np.ndarray]:
    files = sorted(f for f in os.listdir(ckpt_dir) if f.endswith(".safetensors"))
    if not files:
        raise FileNotFoundError(f"no .safetensors files in {ckpt_dir}")
    out: dict[str, np.ndarray] = {}
    for f in files:
        out.update(read_safetensors(os.path.join(ckpt_dir, f)))
    return out


#: HF architectures that map onto the Llama-family layout.  Qwen2 differs
#: from Llama only by qkv biases, Qwen3 by per-head q/k RMSNorms, Mistral by
#: sliding_window.
_LLAMA_LIKE_ARCHS = (
    "LlamaForCausalLM", "MistralForCausalLM", "Qwen2ForCausalLM",
    "Qwen3ForCausalLM",
)


def _rope_scaling_from_hf(hc: dict) -> tuple | None:
    """config.json rope_scaling → the tuple rope_inv_freqs takes; unknown
    kinds raise (loading them unscaled would be silently wrong)."""
    rs = hc.get("rope_scaling")
    if not rs:
        return None
    kind = rs.get("rope_type", rs.get("type", "default"))
    if kind == "default":
        return None
    if kind == "linear":
        return ("linear", float(rs["factor"]))
    if kind == "llama3":
        return (
            "llama3", float(rs["factor"]),
            float(rs["low_freq_factor"]), float(rs["high_freq_factor"]),
            float(rs["original_max_position_embeddings"]),
        )
    raise ValueError(
        f"unsupported rope_scaling type {kind!r} (supported: linear, llama3)")


def _gemma2_config(hc: dict, dtype: str) -> HybridConfig:
    """Gemma2ForCausalLM → HybridConfig: alternating sliding and full layer
    groups, the tanh GELU, ``(1 + w)`` norms, sandwich post-norms, the
    sqrt(hidden) embedding scale, attention and final logit soft-capping,
    and the query_pre_attn_scalar softmax scale."""
    L = hc["num_hidden_layers"]
    head_dim = hc.get("head_dim", hc["hidden_size"] // hc["num_attention_heads"])
    sw = hc.get("sliding_window", 4096)
    if hc.get("layer_types"):
        windows = tuple(sw if t == "sliding_attention" else None for t in hc["layer_types"])
    else:
        # transformers' Gemma2DecoderLayer: even layer indices slide
        windows = tuple(sw if i % 2 == 0 else None for i in range(L))
    return HybridConfig(
        vocab_size=hc["vocab_size"],
        hidden_size=hc["hidden_size"],
        num_layers=L,
        num_heads=hc["num_attention_heads"],
        num_kv_heads=hc.get("num_key_value_heads", hc["num_attention_heads"]),
        head_dim=head_dim,
        intermediate_size=hc["intermediate_size"],
        rope_theta=float(hc.get("rope_theta", 10000.0)),
        rms_eps=float(hc.get("rms_norm_eps", 1e-6)),
        dtype=dtype,
        layer_windows=windows,
        act="gelu_tanh",
        norm_offset=True,
        embed_scale=True,
        post_norms=True,
        attn_softcap=hc.get("attn_logit_softcapping"),
        final_softcap=hc.get("final_logit_softcapping"),
        query_scale=float(hc.get("query_pre_attn_scalar", head_dim)),
        rope_scaling=_rope_scaling_from_hf(hc),
    )


def config_from_hf(ckpt_dir: str, dtype: str = "bfloat16") -> LlamaConfig | HybridConfig:
    with open(os.path.join(ckpt_dir, "config.json")) as f:
        hc = json.load(f)
    archs = hc.get("architectures") or []
    if "Gemma2ForCausalLM" in archs:
        return _gemma2_config(hc, dtype)
    if any(a.startswith("Gemma") for a in archs):
        raise NotImplementedError(
            f"{archs}: Gemma3 (unequal layer groups) is not ported yet")
    if archs and not any(a in _LLAMA_LIKE_ARCHS for a in archs):
        raise ValueError(
            f"unsupported HF architecture {archs}: this loader covers "
            f"{_LLAMA_LIKE_ARCHS}")
    head_dim = hc.get("head_dim", hc["hidden_size"] // hc["num_attention_heads"])
    # Qwen2's qkv biases and Qwen3's q/k norms are architectural
    attention_bias = bool(hc.get("attention_bias", False)) or "Qwen2ForCausalLM" in archs
    qk_norm = "Qwen3ForCausalLM" in archs
    # Qwen records sliding_window but applies it only with
    # use_sliding_window, and then only to layers >= max_window_layers
    sliding = hc.get("sliding_window")
    if "use_sliding_window" in hc:
        L = hc["num_hidden_layers"]
        if not hc["use_sliding_window"]:
            sliding = None
        else:
            if "max_window_layers" not in hc:
                raise ValueError(
                    "use_sliding_window=true without max_window_layers: "
                    "refusing to guess which layers slide")
            mwl = hc["max_window_layers"]
            if mwl >= L:
                sliding = None
            elif mwl > 0:
                raise ValueError(
                    "checkpoint mixes sliding and full layers via "
                    "max_window_layers (the hybrid family, not ported yet)")
    return LlamaConfig(
        vocab_size=hc["vocab_size"],
        hidden_size=hc["hidden_size"],
        num_layers=hc["num_hidden_layers"],
        num_heads=hc["num_attention_heads"],
        num_kv_heads=hc.get("num_key_value_heads", hc["num_attention_heads"]),
        head_dim=head_dim,
        intermediate_size=hc["intermediate_size"],
        rope_theta=float(hc.get("rope_theta", 10000.0)),
        rms_eps=float(hc.get("rms_norm_eps", 1e-5)),
        dtype=dtype,
        sliding_window=sliding,
        attention_bias=attention_bias,
        qk_norm=qk_norm,
        rope_scaling=_rope_scaling_from_hf(hc),
    )


def _stack(tensors: dict, fmt: str, L: int, transpose: bool) -> np.ndarray:
    return np.stack([
        tensors[fmt.format(i)].T if transpose else tensors[fmt.format(i)]
        for i in range(L)
    ])


def _gemma2_params(t: dict, cfg: HybridConfig, cast) -> HybridModel:
    """Gemma2's sandwich-norm layout: ``mlp_norm`` is
    pre_feedforward_layernorm, and post_attention_layernorm really is a
    norm on the attention branch (``post_attn_norm``).  Norm weights stay
    zero-centred, as stored (the model adds the one); the LM head is the
    embedding's transpose (tied)."""
    if "model.layers.0.self_attn.q_norm.weight" in t:
        raise ValueError("a Gemma2 checkpoint has no q/k norms; this one has (Gemma3?)")
    pre, L = "model.layers.{}.", cfg.num_layers
    names = {
        "attn_norm": ("input_layernorm", False),
        "wq": ("self_attn.q_proj", True),
        "wk": ("self_attn.k_proj", True),
        "wv": ("self_attn.v_proj", True),
        "wo": ("self_attn.o_proj", True),
        "post_attn_norm": ("post_attention_layernorm", False),
        "mlp_norm": ("pre_feedforward_layernorm", False),
        "post_ffw_norm": ("post_feedforward_layernorm", False),
        "w_gate": ("mlp.gate_proj", True),
        "w_up": ("mlp.up_proj", True),
        "w_down": ("mlp.down_proj", True),
    }
    layers = {k: cast(_stack(t, pre + hf + ".weight", L, tr)) for k, (hf, tr) in names.items()}
    embed = cast(t["model.embed_tokens.weight"])
    lm_head = (cast(t["lm_head.weight"].T) if "lm_head.weight" in t
               else embed.T.contiguous())  # tied embeddings
    return HybridModel(cfg, embed, layers, cast(t["model.norm.weight"]), lm_head)


def params_from_hf(
    ckpt_dir: str, cfg: LlamaConfig | HybridConfig | None = None,
    dtype: str = "bfloat16", *, device=None,
) -> tuple[LlamaConfig | HybridConfig, LlamaModel]:
    """Load an HF Llama-family or Gemma2 checkpoint onto ``device``
    (default: the card).  HF stores projections output-major ([out, in]);
    every projection is transposed to [in, out] and layers are stacked."""
    if cfg is None:
        cfg = config_from_hf(ckpt_dir, dtype=dtype)
    dev = resolve_device(device)
    t = _load_all_tensors(ckpt_dir)
    L = cfg.num_layers
    tdt = torch_dtype(dtype)

    def cast(x):
        return torch.from_numpy(np.asarray(x, np.float32).copy()).to(device=dev, dtype=tdt)

    if isinstance(cfg, HybridConfig):
        params = _gemma2_params(t, cfg, cast)
        logger.info("loaded HF Gemma2 checkpoint %s: %d layers, %d tensors", ckpt_dir, L,
                    len(t))
        return cfg, params
    pre = "model.layers.{}."
    layers = {
        "attn_norm": _stack(t, pre + "input_layernorm.weight", L, False),
        "wq": _stack(t, pre + "self_attn.q_proj.weight", L, True),
        "wk": _stack(t, pre + "self_attn.k_proj.weight", L, True),
        "wv": _stack(t, pre + "self_attn.v_proj.weight", L, True),
        "wo": _stack(t, pre + "self_attn.o_proj.weight", L, True),
        "mlp_norm": _stack(t, pre + "post_attention_layernorm.weight", L, False),
        "w_gate": _stack(t, pre + "mlp.gate_proj.weight", L, True),
        "w_up": _stack(t, pre + "mlp.up_proj.weight", L, True),
        "w_down": _stack(t, pre + "mlp.down_proj.weight", L, True),
    }
    if pre.format(0) + "self_attn.q_norm.weight" in t:
        # Qwen3-class per-head q/k RMSNorm ([head_dim] vectors)
        layers["q_norm"] = _stack(t, pre + "self_attn.q_norm.weight", L, False)
        layers["k_norm"] = _stack(t, pre + "self_attn.k_norm.weight", L, False)
        cfg = dataclasses.replace(cfg, qk_norm=True)
    elif cfg.qk_norm:
        raise ValueError("config says qk_norm=True but the checkpoint has no "
                         "q_norm/k_norm tensors")
    if pre.format(0) + "self_attn.q_proj.bias" in t:
        # Qwen2-class additive qkv biases (1-D: no transpose)
        layers["bq"] = _stack(t, pre + "self_attn.q_proj.bias", L, False)
        layers["bk"] = _stack(t, pre + "self_attn.k_proj.bias", L, False)
        layers["bv"] = _stack(t, pre + "self_attn.v_proj.bias", L, False)
        cfg = dataclasses.replace(cfg, attention_bias=True)
    elif cfg.attention_bias:
        raise ValueError("config says attention_bias=True but the checkpoint "
                         "has no q_proj.bias tensors")
    embed = cast(t["model.embed_tokens.weight"])
    lm_head = (cast(t["lm_head.weight"].T) if "lm_head.weight" in t
               else embed.T.contiguous())  # tied embeddings
    params = LlamaModel(
        cfg,
        embed=embed,
        layers={k: cast(v) for k, v in layers.items()},
        final_norm=cast(t["model.norm.weight"]),
        lm_head=lm_head,
    )
    logger.info("loaded HF checkpoint %s: %d layers, %d tensors", ckpt_dir, L, len(t))
    return cfg, params
