"""GPT — decoder-only causal transformer for generative serving (PyTorch).

Counterpart of ``deeplearning4j_tpu/models/gpt.py``: the same post-LN block
layout and parameter names (Wq/bq ... W2/b2, ln_gamma/ln_beta), tied
embeddings, and the execution split the serving engine needs:

* :func:`gpt_prefill` — the whole prompt in one causal attention pass
  through the registry's ``dot_product_attention`` (the CUDA flash kernel
  on the card), returning logits and the per-layer K/V for the paged cache.
* :func:`gpt_decode_step` — one token per slot against the block-paged KV
  cache through the registry's ``paged_decode_attention`` (the CUDA paged
  kernel on the card). The cache is updated IN PLACE, where the JAX
  function returns a functionally updated (donated) array.

Parameters are a nested dict of tensors with the JAX pytree's structure
(``{"embeddings": {...}, "blocks": [{"attn": {...}, "ffn": {...}}]}``), so
:func:`params_from_numpy` carries a JAX model across leaf by leaf and the
zip written by the JAX ``save_gpt`` restores here (:func:`restore_gpt`).
"""

from __future__ import annotations

import dataclasses
import json
import math
import zipfile
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.environment import resolve_device
from deeplearning4j_tpu_torch.models._tree import (  # noqa: F401
    leaf_paths as _leaf_paths, map_tree as _map_tree,
    params_from_numpy, rebuild as _rebuild,
)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class GptConfig:
    """GPT-2-small defaults; ``tiny()`` for tests and CPU smoke serving."""

    vocab_size: int = 50257
    hidden: int = 768
    layers: int = 12
    heads: int = 12
    intermediate: int = 3072
    max_position: int = 1024
    layer_norm_eps: float = 1e-5
    eos_token: int = 0

    @staticmethod
    def base(**kw) -> "GptConfig":
        return GptConfig(**kw)

    @staticmethod
    def tiny(**kw) -> "GptConfig":
        d = dict(vocab_size=256, hidden=64, layers=2, heads=4,
                 intermediate=128, max_position=128)
        d.update(kw)
        return GptConfig(**d)

    def to_json(self) -> str:
        return json.dumps({"@type": "GptConfig",
                           **dataclasses.asdict(self)}, indent=1)

    @staticmethod
    def from_json(s: str) -> "GptConfig":
        d = json.loads(s)
        d.pop("@type", None)
        return GptConfig(**d)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------


def param_shapes(cfg: GptConfig) -> Dict[str, Any]:
    """The parameter tree's structure with a shape at every leaf — the
    structure of the JAX ``init_gpt_params`` pytree."""
    e, f = cfg.hidden, cfg.intermediate
    block = {
        "attn": {"Wq": (e, e), "bq": (e,), "Wk": (e, e), "bk": (e,),
                 "Wv": (e, e), "bv": (e,), "Wo": (e, e), "bo": (e,),
                 "ln_gamma": (e,), "ln_beta": (e,)},
        "ffn": {"W1": (e, f), "b1": (f,), "W2": (f, e), "b2": (e,),
                "ln_gamma": (e,), "ln_beta": (e,)},
    }
    return {"embeddings": {"word": (cfg.vocab_size, e),
                           "position": (cfg.max_position, e),
                           "ln_gamma": (e,), "ln_beta": (e,)},
            "blocks": [block for _ in range(cfg.layers)]}


def init_gpt_params(cfg: GptConfig, seed: int = 0,
                    dtype: torch.dtype = torch.float32,
                    device: Union[str, torch.device, None] = None,
                    std: float = 0.02) -> Dict[str, Any]:
    """Random parameters from a numpy seed: N(0, std) matrices and
    embeddings, zero biases, unit LayerNorm gains (the JAX init's scheme
    at the default std; the streams differ, so parity tests carry JAX
    parameters across with :func:`params_from_numpy` instead). At the
    default std a random model's greedy output repeats its last prompt
    token; ``std ~ 2/sqrt(hidden)`` gives varied tokens. ``device``
    defaults to ``"cuda"`` as every entry point does; pass ``"cpu"`` for
    host tensors."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)

    def make(path_shape):
        path, shape = path_shape
        name = path[-1]
        if name == "ln_gamma":
            arr = np.ones(shape, np.float32)
        elif name.startswith("b") or name == "ln_beta":
            arr = np.zeros(shape, np.float32)
        else:
            arr = std * rng.standard_normal(shape, dtype=np.float32)
        return torch.from_numpy(arr).to(device=device, dtype=dtype)

    shapes = param_shapes(cfg)
    made = {path: make((path, shape)) for path, shape in _leaf_paths(shapes)}
    return _rebuild(shapes, made)


# ---------------------------------------------------------------------------
# forward passes
# ---------------------------------------------------------------------------


def _layer_norm(x, gamma, beta, eps):
    """The JAX package's ``_layer_norm`` (``models/bert.py``): population
    variance, rsqrt."""
    mean = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, correction=0)
    return (x - mean) * torch.rsqrt(var + eps) * gamma + beta


def _ffn(blk, x, eps):
    f = blk["ffn"]
    # jax.nn.gelu defaults to the tanh approximation; torch's to exact erf
    hdn = F.gelu(x @ f["W1"] + f["b1"], approximate="tanh")
    return _layer_norm(x + hdn @ f["W2"] + f["b2"],
                       f["ln_gamma"], f["ln_beta"], eps)


def gpt_prefill(params, ids, cfg: GptConfig, *, mask=None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Causal full-prompt forward.

    ids: (N, T) integer; mask: optional (N, T) 1=real token (end padding).
    Returns ``(logits (N, T, V), kv (L, 2, N, T, H, Dh))`` — the per-layer
    keys/values the serving engine scatters into its paged cache."""
    from deeplearning4j_tpu_torch.ops import exec_op

    emb = params["embeddings"]
    n, t = ids.shape
    if t > cfg.max_position:
        raise ValueError(
            f"sequence length {t} exceeds max_position={cfg.max_position}")
    h, dh = cfg.heads, cfg.hidden // cfg.heads
    x = emb["word"][ids.long()] + emb["position"][:t][None]
    x = _layer_norm(x, emb["ln_gamma"], emb["ln_beta"], cfg.layer_norm_eps)

    def split(a):  # (N, T, E) -> (N, H, T, Dh)
        return a.reshape(n, t, h, dh).permute(0, 2, 1, 3)

    m4 = None if mask is None else mask[:, None, None, :].bool()
    kvs = []
    for blk in params["blocks"]:
        a = blk["attn"]
        q = split(x @ a["Wq"] + a["bq"])
        k = split(x @ a["Wk"] + a["bk"])
        v = split(x @ a["Wv"] + a["bv"])
        # (2, N, T, H, Dh) — token-major, the paged-cache scatter layout
        kvs.append(torch.stack([k.permute(0, 2, 1, 3),
                                v.permute(0, 2, 1, 3)]))
        out = exec_op("dot_product_attention", q, k, v, m4, scaled=True,
                      causal=True)
        out = out.permute(0, 2, 1, 3).reshape(n, t, cfg.hidden)
        x = _layer_norm(x + out @ a["Wo"] + a["bo"],
                        a["ln_gamma"], a["ln_beta"], cfg.layer_norm_eps)
        x = _ffn(blk, x, cfg.layer_norm_eps)
    logits = x @ emb["word"].T
    return logits, torch.stack(kvs)


def gpt_decode_step(params, kv_pages, tokens, positions, page_table,
                    seq_lens_incl, write_page, write_offset, cfg: GptConfig
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decode token for every slot, against the paged KV cache.

    kv_pages: (L, 2, P, page, H, Dh) — written IN PLACE (each slot's new
    K/V at ``(write_page, write_offset)``; the engine points inactive slots
    at its trash page); tokens/positions: (S,) — the token fed and its
    position; page_table: (S, max_pages) int32; seq_lens_incl: (S,) int32
    valid length INCLUDING this token. Returns ``(kv_pages, logits (S,
    V))``; the returned cache is the argument itself."""
    from deeplearning4j_tpu_torch.ops import exec_op

    emb = params["embeddings"]
    s_n = tokens.shape[0]
    h, dh = cfg.heads, cfg.hidden // cfg.heads
    pos = positions.long().clamp(0, cfg.max_position - 1)
    x = emb["word"][tokens.long()] + emb["position"][pos]
    x = _layer_norm(x, emb["ln_gamma"], emb["ln_beta"], cfg.layer_norm_eps)
    wp, wo = write_page.long(), write_offset.long()
    for li, blk in enumerate(params["blocks"]):
        a = blk["attn"]
        q = (x @ a["Wq"] + a["bq"]).reshape(s_n, h, dh)
        k = (x @ a["Wk"] + a["bk"]).reshape(s_n, h, dh)
        v = (x @ a["Wv"] + a["bv"]).reshape(s_n, h, dh)
        kv_pages[li, 0, wp, wo] = k.to(kv_pages.dtype)
        kv_pages[li, 1, wp, wo] = v.to(kv_pages.dtype)
        # kv_pages[li, 0] is a contiguous view of the cache: no copy
        attn = exec_op("paged_decode_attention", q.contiguous(),
                       kv_pages[li, 0], kv_pages[li, 1], page_table,
                       seq_lens_incl, scale=1.0 / math.sqrt(dh))
        attn = attn.reshape(s_n, cfg.hidden)
        x = _layer_norm(x + attn @ a["Wo"] + a["bo"],
                        a["ln_gamma"], a["ln_beta"], cfg.layer_norm_eps)
        x = _ffn(blk, x, cfg.layer_norm_eps)
    logits = x @ emb["word"].T
    return kv_pages, logits


@torch.inference_mode()
def reference_generate(params, cfg: GptConfig, prompt, n_new: int
                       ) -> np.ndarray:
    """Greedy autoregressive oracle: re-runs the FULL causal prefill for
    every generated token — O(T^2) per token, test-sized only."""
    device = params["embeddings"]["word"].device
    toks: List[int] = list(np.asarray(prompt).tolist())
    for _ in range(n_new):
        ids = torch.tensor([toks], dtype=torch.long, device=device)
        logits, _ = gpt_prefill(params, ids, cfg)
        toks.append(int(torch.argmax(logits[0, -1])))
    return np.array(toks[len(prompt):], np.int32)


class GptModel:
    """Decoder model handle: config + parameters on a device (+ serde). The
    serving loop (``serving.GenerativeEngine``) owns batching, cache and
    sampling. ``device`` defaults to the environment's (``"cuda"``); a host
    without a GPU raises unless the caller asks for ``"cpu"``."""

    def __init__(self, cfg: GptConfig, seed: int = 0,
                 dtype: torch.dtype = torch.float32,
                 params: Optional[Dict[str, Any]] = None,
                 device: Union[str, torch.device, None] = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        if params is None:
            params = init_gpt_params(cfg, seed, dtype, self.device)
        else:
            params = _map_tree(lambda t: t.to(self.device), params)
        self.params = params

    @property
    def dtype(self) -> torch.dtype:
        return self.params["embeddings"]["word"].dtype

    @torch.inference_mode()
    def logits(self, ids) -> np.ndarray:
        """Convenience full-sequence forward (no cache)."""
        ids = torch.as_tensor(np.asarray(ids), device=self.device)
        out, _ = gpt_prefill(self.params, ids, self.cfg)
        return out.float().cpu().numpy()


# ---------------------------------------------------------------------------
# serde — the zip layout of the JAX package's save_gpt
# ---------------------------------------------------------------------------


def save_gpt(model: GptModel, path: str) -> None:
    """configuration.json + meta.json + coefficients.bin (float32, leaves
    in ``jax.tree.leaves`` order) — readable by the JAX ``restore_gpt``."""
    dtype = str(model.dtype).replace("torch.", "")
    flat = np.concatenate([t.detach().float().cpu().numpy().reshape(-1)
                           for _, t in _leaf_paths(model.params)])
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as z:
        z.writestr("configuration.json", model.cfg.to_json())
        z.writestr("meta.json", json.dumps({"dtype": dtype}))
        z.writestr("coefficients.bin", flat.astype(np.float32).tobytes())


def restore_gpt(path: str, device: Union[str, torch.device, None] = None
                ) -> GptModel:
    """Load a zip written by either package's ``save_gpt`` onto ``device``
    (default: the environment's, ``"cuda"``)."""
    dev = resolve_device(device)
    with zipfile.ZipFile(path, "r") as z:
        cfg = GptConfig.from_json(z.read("configuration.json").decode())
        flat = np.frombuffer(z.read("coefficients.bin"), np.float32)
        dtype = torch.float32
        if "meta.json" in z.namelist():
            dtype = _DTYPES[json.loads(z.read("meta.json"))["dtype"]]
    shapes = param_shapes(cfg)
    by_path, offset = {}, 0
    for p, shape in _leaf_paths(shapes):
        size = int(np.prod(shape))
        chunk = flat[offset:offset + size]
        if chunk.size != size:
            raise ValueError(
                f"coefficients buffer exhausted at {p}: needs {size} "
                f"values, {chunk.size} left — config/params mismatch")
        by_path[p] = torch.from_numpy(chunk.reshape(shape).copy()).to(
            device=dev, dtype=dtype)
        offset += size
    if offset != flat.size:
        raise ValueError(f"coefficients buffer has {flat.size - offset} "
                         f"trailing values — config/params mismatch")
    return GptModel(cfg, params=_rebuild(shapes, by_path), device=dev)
