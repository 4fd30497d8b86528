"""The paper's six benchmark DNNs (Table 3), as torch functions that the
port's tracer (``core.torch_export``) runs on meta tensors: the counterpart
of ``repro.core.zoo``.

They are the strategy search's subjects: only their computation graphs
matter (real dimensions, abstract parameters, nothing allocated), so each
builder returns ``(loss_fn, params, batch)`` with ``params`` and ``batch``
as meta tensors of ``repro``'s element counts and dtypes, under ``repro``'s
names. Images are NCHW and kernels OIHW, torch's layouts; every kernel is
odd, so a symmetric padding of ``k // 2`` gives the output size of JAX's
``"SAME"``. The attention blocks keep ``repro``'s hand-written layer norm
and masked softmax: the graph's op mix is what the planner sees.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

f32 = torch.float32


def _sds(*shape, dtype=f32):
    return torch.empty(tuple(int(s) for s in shape), dtype=dtype, device="meta")


def _oihw(kh, kw, cin, cout):
    """A conv kernel of ``repro``'s HWIO ``(kh, kw, cin, cout)`` as OIHW."""
    return _sds(cout, cin, kh, kw)


def _conv(x, w, stride=1):
    return F.conv2d(x, w, stride=stride, padding=w.shape[-1] // 2)


def _pool(x, k=2):
    return F.max_pool2d(x, k, k)


def _softmax_ce(logits, labels):
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[:, None])[:, 0]
    return torch.mean(logz - gold)


# ----------------------------------------------------------------- VGG19

_VGG_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
            512, 512, 512, 512, "M", 512, 512, 512, 512, "M"]


def vgg19(batch: int = 96):
    params, cin = {}, 3
    for i, c in enumerate(_VGG_CFG):
        if c == "M":
            continue
        params[f"conv{i}"] = _oihw(3, 3, cin, c)
        cin = c
    params["fc1"] = _sds(7 * 7 * 512, 4096)
    params["fc2"] = _sds(4096, 4096)
    params["fc3"] = _sds(4096, 1000)

    def loss_fn(p, b):
        x = b["image"]
        for i, c in enumerate(_VGG_CFG):
            if c == "M":
                x = _pool(x)
            else:
                x = torch.relu(_conv(x, p[f"conv{i}"]))
        x = x.reshape(x.shape[0], -1)
        x = torch.relu(x @ p["fc1"])
        x = torch.relu(x @ p["fc2"])
        return _softmax_ce(x @ p["fc3"], b["label"])

    batch_specs = {"image": _sds(batch, 3, 224, 224),
                   "label": _sds(batch, dtype=torch.int32)}
    return loss_fn, params, batch_specs


# -------------------------------------------------------------- ResNet101

_RESNET_STAGES = [(64, 3), (128, 4), (256, 23), (512, 3)]


def resnet101(batch: int = 96):
    params = {"stem": _oihw(7, 7, 3, 64)}
    cin = 64
    for s, (c, blocks) in enumerate(_RESNET_STAGES):
        for b in range(blocks):
            pfx = f"s{s}b{b}"
            params[pfx + "c1"] = _oihw(1, 1, cin if b == 0 else 4 * c, c)
            params[pfx + "c2"] = _oihw(3, 3, c, c)
            params[pfx + "c3"] = _oihw(1, 1, c, 4 * c)
            if b == 0:
                params[pfx + "proj"] = _oihw(1, 1, cin, 4 * c)
        cin = 4 * c
    params["fc"] = _sds(2048, 1000)

    def loss_fn(p, b):
        x = torch.relu(_conv(b["image"], p["stem"], stride=2))
        x = _pool(x)
        for s, (_c, blocks) in enumerate(_RESNET_STAGES):
            for blk in range(blocks):
                pfx = f"s{s}b{blk}"
                stride = 2 if (blk == 0 and s > 0) else 1
                h = torch.relu(_conv(x, p[pfx + "c1"], stride=stride))
                h = torch.relu(_conv(h, p[pfx + "c2"]))
                h = _conv(h, p[pfx + "c3"])
                sc = _conv(x, p[pfx + "proj"], stride=stride) \
                    if pfx + "proj" in p else x
                x = torch.relu(h + sc)
        x = torch.mean(x, dim=(2, 3))
        return _softmax_ce(x @ p["fc"], b["label"])

    batch_specs = {"image": _sds(batch, 3, 224, 224),
                   "label": _sds(batch, dtype=torch.int32)}
    return loss_fn, params, batch_specs


# ------------------------------------------------------------ InceptionV3

def inception_v3(batch: int = 96):
    """Simplified Inception: stem + 8 mixed blocks with parallel towers."""
    params = {"stem1": _oihw(3, 3, 3, 32), "stem2": _oihw(3, 3, 32, 64),
              "stem3": _oihw(3, 3, 64, 192)}
    cin = 192
    widths = [256, 288, 288, 768, 768, 768, 1280, 2048]
    for i, w in enumerate(widths):
        b = w // 4
        params[f"m{i}t1"] = _oihw(1, 1, cin, b)
        params[f"m{i}t2a"] = _oihw(1, 1, cin, b)
        params[f"m{i}t2b"] = _oihw(3, 3, b, b)
        params[f"m{i}t3a"] = _oihw(1, 1, cin, b)
        params[f"m{i}t3b"] = _oihw(3, 3, b, b)
        params[f"m{i}t3c"] = _oihw(3, 3, b, b)
        params[f"m{i}t4"] = _oihw(1, 1, cin, w - 3 * b)
        cin = w
    params["fc"] = _sds(2048, 1000)

    def loss_fn(p, b):
        x = torch.relu(_conv(b["image"], p["stem1"], stride=2))
        x = torch.relu(_conv(x, p["stem2"]))
        x = torch.relu(_conv(x, p["stem3"]))
        x = _pool(x)
        for i, _w in enumerate(widths):
            t1 = torch.relu(_conv(x, p[f"m{i}t1"]))
            t2 = torch.relu(_conv(torch.relu(_conv(x, p[f"m{i}t2a"])),
                                  p[f"m{i}t2b"]))
            t3 = torch.relu(_conv(x, p[f"m{i}t3a"]))
            t3 = torch.relu(_conv(t3, p[f"m{i}t3b"]))
            t3 = torch.relu(_conv(t3, p[f"m{i}t3c"]))
            t4 = torch.relu(_conv(x, p[f"m{i}t4"]))
            x = torch.cat([t1, t2, t3, t4], dim=1)
            if i in (2, 5):
                x = _pool(x)
        x = torch.mean(x, dim=(2, 3))
        return _softmax_ce(x @ p["fc"], b["label"])

    batch_specs = {"image": _sds(batch, 3, 149, 149),
                   "label": _sds(batch, dtype=torch.int32)}
    return loss_fn, params, batch_specs


# ------------------------------------------------- Transformer / BERT

def _attn_block_params(d: int, dff: int, pfx: str):
    return {
        pfx + "wq": _sds(d, d), pfx + "wk": _sds(d, d),
        pfx + "wv": _sds(d, d), pfx + "wo": _sds(d, d),
        pfx + "w1": _sds(d, dff), pfx + "w2": _sds(dff, d),
        pfx + "ln1": _sds(d), pfx + "ln2": _sds(d),
    }


def _attn_block(p, x, pfx, heads: int, causal: bool = False):
    B, S, d = x.shape
    hd = d // heads

    def ln(h, g):
        mu = torch.mean(h, -1, keepdim=True)
        var = torch.mean((h - mu) ** 2, -1, keepdim=True)
        return (h - mu) * torch.rsqrt(var + 1e-5) * g

    h = ln(x, p[pfx + "ln1"])
    q = (h @ p[pfx + "wq"]).reshape(B, S, heads, hd)
    k = (h @ p[pfx + "wk"]).reshape(B, S, heads, hd)
    v = (h @ p[pfx + "wv"]).reshape(B, S, heads, hd)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
    if causal:
        mask = torch.tril(torch.ones((S, S), dtype=torch.bool, device=x.device))
        s = torch.where(mask, s, -1e30)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", w, v).reshape(B, S, d)
    x = x + o @ p[pfx + "wo"]
    h = ln(x, p[pfx + "ln2"])
    return x + torch.relu(h @ p[pfx + "w1"]) @ p[pfx + "w2"]


def _bert_like(layers: int, d: int, dff: int, heads: int, vocab: int,
               batch: int, seq: int, causal: bool = False):
    params = {"embed": _sds(vocab, d), "pos": _sds(seq, d)}
    for i in range(layers):
        params.update(_attn_block_params(d, dff, f"l{i}_"))

    def loss_fn(p, b):
        x = p["embed"][b["tokens"]] + p["pos"][None]
        for i in range(layers):
            x = _attn_block(p, x, f"l{i}_", heads, causal)
        logits = x @ p["embed"].T   # tied head
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, b["labels"].long()[..., None])[..., 0]
        return torch.mean(logz - gold)

    batch_specs = {"tokens": _sds(batch, seq, dtype=torch.int32),
                   "labels": _sds(batch, seq, dtype=torch.int32)}
    return loss_fn, params, batch_specs


def transformer(batch: int = 480):
    # paper: 407MB params — decoder-only stack, 32k vocab (tied embeddings)
    return _bert_like(6, 1024, 4096, 16, 32_000, batch, 128, causal=True)


def bert_small(batch: int = 96):
    return _bert_like(4, 512, 2048, 8, 30_522, batch, 128)


def bert_large(batch: int = 16):
    return _bert_like(24, 1024, 4096, 16, 30_522, batch, 384)


ZOO = {
    "inception_v3": inception_v3,
    "resnet101": resnet101,
    "vgg19": vgg19,
    "transformer": transformer,
    "bert_small": bert_small,
    "bert_large": bert_large,
}


def build(name: str, batch: int | None = None, scale: float = 1.0):
    """Build a zoo model; ``batch`` overrides the paper's batch size."""
    fn = ZOO[name]
    kwargs = {} if batch is None else {"batch": batch}
    return fn(**kwargs)
