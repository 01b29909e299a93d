"""MLPerf-proxy workloads at the paper's Table III batch sizes.

The paper traces NVIDIA's MLPerf Training v0.6 / Inference v0.5 submissions
on a V100 and replays them through a proprietary simulator. We cannot ship
those traces, so each benchmark is regenerated *analytically* from its
published architecture at the paper's per-GPU batch sizes. Footprints land
within the same regime as Table III (asserted in tests); exact per-kernel
fidelity is neither possible nor required — the evaluation reproduces the
paper's aggregate behaviours (Figs 2,4,8,9,11,12).

Table III (paper):
    training:   resnet 12/128, ssd 4/128, maskrcnn 1/6, minigo 128/2048,
                gnmt 32/256, transformer 640/5120 (tokens), ncf 65,536/1,048,576
    inference:  resnet 1/232, mobilenet 1/704, ssd-small 1/288,
                ssd-large 1/6, gnmt 1/128
"""
from __future__ import annotations

from functools import lru_cache

from repro_torch.core.trace import Trace
from repro_torch.workloads.common import ModelBuilder

MB = 1024 * 1024


# --------------------------------------------------------------------------------
# Vision backbones
# --------------------------------------------------------------------------------

def _resnet_backbone(mb: ModelBuilder, n: int, h: int, w: int,
                     stages: tuple[int, ...], widths: tuple[int, ...],
                     bottleneck: bool, in_ch: int = 3,
                     fuse_residual: bool = False) -> tuple[str, int, int, int]:
    x, hh, ww = mb.conv("conv1", "in.img", n, h, w, in_ch, 64, 7, 7, stride=2)
    x = mb.eltwise("bn1", x, n * hh * ww * 64 * mb.dtype_bytes())
    hh, ww = hh // 2, ww // 2  # maxpool
    cin = 64
    for si, (blocks, width) in enumerate(zip(stages, widths)):
        for bi in range(blocks):
            stride = 2 if (bi == 0 and si > 0) else 1
            name = f"s{si}b{bi}"
            # BN+ReLU are fused into the producing conv (as in NVIDIA's MLPerf
            # submissions), so they add no standalone traffic; the residual
            # add remains a real kernel.
            if bottleneck:
                cout = width * 4
                y, h2, w2 = mb.conv(f"{name}.c1", x, n, hh, ww, cin, width, 1, 1, stride)
                y, _, _ = mb.conv(f"{name}.c2", y, n, h2, w2, width, width, 3, 3)
                y, _, _ = mb.conv(f"{name}.c3", y, n, h2, w2, width, cout, 1, 1)
            else:
                cout = width
                y, h2, w2 = mb.conv(f"{name}.c1", x, n, hh, ww, cin, width, 3, 3, stride)
                y, _, _ = mb.conv(f"{name}.c2", y, n, h2, w2, width, cout, 3, 3)
            act_bytes = n * h2 * w2 * cout * mb.dtype_bytes()
            if fuse_residual:
                # Inference deployments (TensorRT-class) fuse conv+add+relu:
                # the skip connection is consumed inside the last conv kernel.
                if stride == 1 and cin == cout:
                    self_read = (x, act_bytes)
                    mb.layers[-1].extra_reads = mb.layers[-1].extra_reads + (self_read,)
            else:
                y = mb.eltwise(f"{name}.bnadd", y, act_bytes,
                               extra_reads=((x, act_bytes if (stride == 1 and cin == cout) else 0),))
            x, hh, ww, cin = y, h2, w2, cout
    return x, hh, ww, cin


def resnet50(batch: int, h: int = 224, w: int = 224,
             fuse_residual: bool = False) -> ModelBuilder:
    mb = ModelBuilder(f"resnet50.b{batch}")
    x, hh, ww, c = _resnet_backbone(mb, batch, h, w, (3, 4, 6, 3),
                                    (64, 128, 256, 512), bottleneck=True,
                                    fuse_residual=fuse_residual)
    x = mb.eltwise("gap", x, batch * c * mb.dtype_bytes(), stash=False)
    mb.gemm("fc", x, batch, c, 1000)
    return mb


def resnet34_ssd(batch: int, res: int, fuse_residual: bool = False) -> ModelBuilder:
    mb = ModelBuilder(f"ssd.r34.{res}.b{batch}")
    x, hh, ww, c = _resnet_backbone(mb, batch, res, res, (3, 4, 6),
                                    (64, 128, 256), bottleneck=False,
                                    fuse_residual=fuse_residual)
    # SSD extra feature layers + multibox heads
    feats = [(x, hh, ww, c)]
    for i, cout in enumerate((512, 512, 256, 256)):
        x, _, _ = mb.conv(f"extra{i}.a", x, batch, hh, ww, c, cout // 2, 1, 1)
        x, hh, ww = mb.conv(f"extra{i}.b", x, batch, hh, ww, cout // 2, cout, 3, 3, stride=2)
        c = cout
        feats.append((x, hh, ww, c))
    for i, (f, fh, fw, fc) in enumerate(feats):
        mb.conv(f"head{i}.loc", f, batch, fh, fw, fc, 4 * 4, 3, 3)
        mb.conv(f"head{i}.conf", f, batch, fh, fw, fc, 4 * 81, 3, 3)
    return mb


def mobilenet_v1(batch: int, res: int = 224, width: float = 1.0,
                 fuse_dw: bool = False) -> ModelBuilder:
    mb = ModelBuilder(f"mobilenet.b{batch}")
    ch = int(32 * width)
    x, h, w = mb.conv("conv1", "in.img", batch, res, res, 3, ch, 3, 3, stride=2)
    plan = [(64, 1), (128, 2), (128, 1), (256, 2), (256, 1), (512, 2),
            *[(512, 1)] * 5, (1024, 2), (1024, 1)]
    for i, (cout, s) in enumerate(plan):
        cout = int(cout * width)
        if fuse_dw:
            # TensorRT-class inference fuses dw+pw+relu: the depthwise
            # intermediate never leaves on-chip storage.
            dw_flops = 2.0 * batch * (h // s) * (w // s) * ch * 9
            x, h, w = mb.conv(f"dwpw{i}", x, batch, h, w, ch, cout, 1, 1)
            if s > 1:
                h, w = -(-h // s), -(-w // s)
                mb.layers[-1].y_bytes = batch * h * w * cout * mb.dtype_bytes()
            mb.layers[-1].flops += dw_flops
            mb.layers[-1].w_bytes += ch * 9 * mb.dtype_bytes()
        else:
            x, h, w = mb.dwconv(f"dw{i}", x, batch, h, w, ch, 3, 3, stride=s)
            x, h, w = mb.conv(f"pw{i}", x, batch, h, w, ch, cout, 1, 1)
        ch = cout
    x = mb.eltwise("gap", x, batch * ch * mb.dtype_bytes(), stash=False)
    mb.gemm("fc", x, batch, ch, 1000)
    return mb


def maskrcnn(batch: int) -> ModelBuilder:
    """ResNet50-FPN @ 800x1344 + RPN + box/mask heads over 1000 ROIs."""
    mb = ModelBuilder(f"maskrcnn.b{batch}")
    x, hh, ww, c = _resnet_backbone(mb, batch, 800, 1344, (3, 4, 6, 3),
                                    (64, 128, 256, 512), bottleneck=True)
    # FPN lateral+output convs on 4 levels (approximate level sizes)
    for lvl, (fh, fw, fc) in enumerate(((100, 168, 2048), (100, 168, 1024),
                                        (200, 336, 512), (400, 672, 256))):
        l, _, _ = mb.conv(f"fpn.lat{lvl}", None, batch, fh, fw, fc, 256, 1, 1)
        o, _, _ = mb.conv(f"fpn.out{lvl}", l, batch, fh, fw, 256, 256, 3, 3)
        mb.conv(f"rpn{lvl}", o, batch, fh, fw, 256, 256, 3, 3)
    rois = 1000 * batch
    # box head: 2 FC on 7x7x256 pooled features
    x = mb.gemm("box.fc1", None, rois, 7 * 7 * 256, 1024,
                x_bytes=rois * 7 * 7 * 256 * mb.dtype_bytes())
    x = mb.gemm("box.fc2", x, rois, 1024, 1024)
    mb.gemm("box.cls", x, rois, 1024, 81 * 5)
    # mask head: 4 conv on 14x14 + deconv
    m = None
    fh = 14
    for i in range(4):
        m, _, _ = mb.conv(f"mask.c{i}", m, rois, fh, fh, 256, 256, 3, 3)
    mb.conv("mask.deconv", m, rois, 28, 28, 256, 81, 1, 1)
    return mb


def minigo(batch: int) -> ModelBuilder:
    """AlphaZero-style residual tower on a 19x19 board (proxy: 9 blocks x64,
    BN folded/recomputed — calibrated to Table III's 105MB/1.5GB footprints)."""
    mb = ModelBuilder(f"minigo.b{batch}")
    ch = 64
    x, _, _ = mb.conv("stem", "in.board", batch, 19, 19, 17, ch, 3, 3)
    for i in range(9):
        y, _, _ = mb.conv(f"rb{i}.c1", x, batch, 19, 19, ch, ch, 3, 3)
        y = mb.eltwise(f"rb{i}.bn1", y, batch * 361 * ch * mb.dtype_bytes(),
                       stash=False)
        y, _, _ = mb.conv(f"rb{i}.c2", y, batch, 19, 19, ch, ch, 3, 3)
        act = batch * 361 * ch * mb.dtype_bytes()
        x = mb.eltwise(f"rb{i}.add", y, act, extra_reads=((x, act),),
                       stash=False)
    p, _, _ = mb.conv("policy.conv", x, batch, 19, 19, ch, 2, 1, 1)
    mb.gemm("policy.fc", p, batch, 2 * 361, 362)
    v, _, _ = mb.conv("value.conv", x, batch, 19, 19, ch, 1, 1, 1)
    v = mb.gemm("value.fc1", v, batch, 361, 256)
    mb.gemm("value.fc2", v, batch, 256, 1)
    return mb


# --------------------------------------------------------------------------------
# NLP / recommender
# --------------------------------------------------------------------------------

def gnmt(batch: int, seq: int = 50, hidden: int = 1024, vocab: int = 32000,
         decode_only: bool = False) -> ModelBuilder:
    """GNMT: 8-layer encoder + 8-layer decoder LSTM w/ attention.

    LSTM steps are emitted per (layer, unrolled-chunk): the recurrent GEMMs
    at a given layer reuse their weights every timestep — the inter-kernel
    reuse pattern the paper highlights. We chunk timesteps by 8 to keep the
    trace compact while preserving the reuse structure.
    """
    mb = ModelBuilder(f"gnmt.b{batch}")
    e = mb.dtype_bytes()
    chunk = 8
    mb.gather("src.embed", vocab * hidden * e, batch * seq * hidden * e)
    sides = ["dec"] if decode_only else ["enc", "dec"]
    for side in sides:
        for layer in range(8):
            w_x, w_h = f"{side}.l{layer}.W", f"{side}.l{layer}.U"
            for t0 in range(0, seq, chunk):
                steps = min(chunk, seq - t0)
                m = batch * steps
                name = f"{side}.l{layer}.t{t0}"
                x = mb.gemm(f"{name}.xw", None, m, hidden, 4 * hidden,
                            x_bytes=m * hidden * e, shared_w=w_x)
                h = mb.gemm(f"{name}.hu", None, m, hidden, 4 * hidden,
                            x_bytes=m * hidden * e, shared_w=w_h)
                mb.eltwise(f"{name}.gates", x, m * 4 * hidden * e,
                           extra_reads=((h, m * 4 * hidden * e),))
            if side == "dec" and layer == 0:
                # Bahdanau-ish attention over encoder states
                mb.attention(f"attn", None if decode_only else x, batch,
                             seq, seq, heads=1, dim=hidden, chunked=False,
                             causal=False)
    mb.gemm("logits", None, batch * seq, hidden, vocab,
            x_bytes=batch * seq * hidden * e)
    return mb


def transformer_big(batch_tokens: int, seq: int = 64, d: int = 1024,
                    ff: int = 4096, heads: int = 16, vocab: int = 32768) -> ModelBuilder:
    """MLPerf 'transformer' = Transformer-big for WMT en-de."""
    mb = ModelBuilder(f"transformer.t{batch_tokens}")
    e = mb.dtype_bytes()
    b = max(batch_tokens // seq, 1)
    tokens = b * seq
    mb.gather("embed", vocab * d * e, tokens * d * e)
    x = None
    for side, nlayers in (("enc", 6), ("dec", 6)):
        for l in range(nlayers):
            name = f"{side}{l}"
            x = mb.attention(f"{name}.self", x, b, seq, seq, heads, d // heads,
                             chunked=False, causal=(side == "dec"))
            x = mb.eltwise(f"{name}.ln1", x, tokens * d * e)
            if side == "dec":
                x = mb.attention(f"{name}.cross", x, b, seq, seq, heads,
                                 d // heads, chunked=False, causal=False)
                x = mb.eltwise(f"{name}.lnx", x, tokens * d * e)
            h = mb.gemm(f"{name}.ff1", x, tokens, d, ff)
            h = mb.eltwise(f"{name}.relu", h, tokens * ff * e, stash=False)
            x = mb.gemm(f"{name}.ff2", h, tokens, ff, d)
            x = mb.eltwise(f"{name}.ln2", x, tokens * d * e)
    mb.gemm("logits", x, tokens, d, vocab)
    return mb


def ncf(batch: int, n_users: int = 138_493, n_items: int = 26_744,
        dim: int = 128) -> ModelBuilder:
    """Neural collaborative filtering on ml-20m (MLPerf v0.6 scale)."""
    mb = ModelBuilder(f"ncf.b{batch}")
    e = mb.dtype_bytes()
    mb.gather("user.embed", n_users * dim * e, batch * dim * e)
    mb.gather("item.embed", n_items * dim * e, batch * dim * e)
    mb.gather("user.embed.mf", n_users * (dim // 2) * e, batch * (dim // 2) * e)
    mb.gather("item.embed.mf", n_items * (dim // 2) * e, batch * (dim // 2) * e)
    x = mb.gemm("mlp1", None, batch, 2 * dim, 256, x_bytes=batch * 2 * dim * e)
    x = mb.gemm("mlp2", x, batch, 256, 128)
    x = mb.gemm("mlp3", x, batch, 128, 64)
    mb.gemm("out", x, batch, 64 + dim // 2, 1, x_bytes=batch * (64 + dim // 2) * e)
    return mb


# --------------------------------------------------------------------------------
# Suite assembly (Table III)
# --------------------------------------------------------------------------------

TRAIN_BATCHES = {  # name -> (small, large)
    "resnet": (12, 128),
    "ssd": (4, 128),
    "maskrcnn": (1, 6),
    "minigo": (128, 2048),
    "gnmt": (32, 256),
    "transformer": (640, 5120),
    "ncf": (65536, 1048576),
}

INFER_BATCHES = {
    "resnet": (1, 232),
    "mobilenet": (1, 704),
    "ssd-small": (1, 288),
    "ssd-large": (1, 6),
    "gnmt": (1, 128),
}


def _build_train(name: str, batch: int) -> ModelBuilder:
    if name == "resnet":
        return resnet50(batch)
    if name == "ssd":
        return resnet34_ssd(batch, res=300)
    if name == "maskrcnn":
        return maskrcnn(batch)
    if name == "minigo":
        return minigo(batch)
    if name == "gnmt":
        return gnmt(batch)
    if name == "transformer":
        return transformer_big(batch)
    if name == "ncf":
        return ncf(batch)
    raise KeyError(name)


def _build_infer(name: str, batch: int) -> ModelBuilder:
    if name == "resnet":
        return resnet50(batch, fuse_residual=True)
    if name == "mobilenet":
        return mobilenet_v1(batch, fuse_dw=True)
    if name == "ssd-small":
        mb = mobilenet_v1(batch, res=300, fuse_dw=True)
        mb.name = f"ssd-small.b{batch}"
        return mb
    if name == "ssd-large":
        return resnet34_ssd(batch, res=1200, fuse_residual=True)
    if name == "gnmt":
        return gnmt(batch, decode_only=True)
    raise KeyError(name)


_OPTIM = {"resnet": "sgdm", "ssd": "sgdm", "maskrcnn": "sgdm",
          "minigo": "sgdm", "gnmt": "adam", "transformer": "adam", "ncf": "adam"}


@lru_cache(maxsize=64)
def training_trace(name: str, batch_setting: str = "large",
                   batch_override: int | None = None) -> Trace:
    small, large = TRAIN_BATCHES[name]
    batch = batch_override or (large if batch_setting == "large" else small)
    mb = _build_train(name, batch)
    t = mb.trace(training=True, batch_size=batch, optimizer=_OPTIM[name])
    # Batch-override traces get a distinct name: grids key rows by trace
    # name, and a scale-out sweep holds several batches of one benchmark.
    t.name = f"{name}.train.{batch_setting}" if batch_override is None \
        else f"{name}.train.b{batch}"
    return t


@lru_cache(maxsize=64)
def inference_trace(name: str, batch_setting: str = "large",
                    batch_override: int | None = None) -> Trace:
    small, large = INFER_BATCHES[name]
    batch = batch_override or (large if batch_setting == "large" else small)
    mb = _build_infer(name, batch)
    t = mb.trace(training=False, batch_size=batch)
    t.name = f"{name}.infer.{batch_setting}" if batch_override is None \
        else f"{name}.infer.b{batch}"
    return t


def training_suite(batch_setting: str) -> list[Trace]:
    return [training_trace(n, batch_setting) for n in TRAIN_BATCHES]


def inference_suite(batch_setting: str) -> list[Trace]:
    return [inference_trace(n, batch_setting) for n in INFER_BATCHES]
