"""ResNet v1.5: NHWC activations, bf16 compute, fp32 master parameters.
The port of ``paddle_operator_tpu/models/resnet.py``, with the same tree
keys (``stem``, ``stages[i][j]``, ``head``) and layouts (HWIO conv kernels,
``[in, out]`` dense kernel), so a JAX-initialised tree runs here through
:mod:`..bridge` unchanged.

v1.5: a bottleneck block's stride sits on its 3x3 ``conv2``. BatchNorm
running stats live inside the tree; :func:`apply` returns
``(logits, stats)`` with ``stats`` mapping flat paths to new
``{mean, var}``, which :func:`merge_stats` folds in after the optimizer
step.

Under an ``fsdp`` axis with ``resnet_rules`` (the train step's
:func:`..parallel.collectives.model_tiles`) the classifier's kernel is
this rank's columns ``[2048, classes/n]``: the head is column-parallel,
its tiles of the logits gathered over fsdp and the replicated bias added
after the gather. The fsdp ranks see the same images.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from ..ops import nn
from ..parallel import collectives

# depth -> (block counts, bottleneck?)
CONFIGS = {
    18: ([2, 2, 2, 2], False),
    34: ([3, 4, 6, 3], False),
    50: ([3, 4, 6, 3], True),
    101: ([3, 4, 23, 3], True),
    152: ([3, 8, 36, 3], True),
}

STAGE_CH = [64, 128, 256, 512]


def init(generator: torch.Generator, depth: int = 50,
         num_classes: int = 1000) -> Dict:
    """Random fp32 parameters drawn from ``generator``, on its device."""
    blocks, bottleneck = CONFIGS[depth]
    expansion = 4 if bottleneck else 1
    dev = generator.device
    params: Dict = {
        "stem": {"conv": nn.conv_init(generator, 7, 7, 3, 64),
                 "bn": nn.batchnorm_init(64, dev)},
        "stages": [],
    }
    in_ch = 64
    for si, n_blocks in enumerate(blocks):
        stage: List[Dict] = []
        out_ch = STAGE_CH[si] * expansion
        mid = STAGE_CH[si]
        for bi in range(n_blocks):
            stride = 2 if (si > 0 and bi == 0) else 1
            if bottleneck:
                block = {
                    "conv1": nn.conv_init(generator, 1, 1, in_ch, mid),
                    "bn1": nn.batchnorm_init(mid, dev),
                    "conv2": nn.conv_init(generator, 3, 3, mid, mid),
                    "bn2": nn.batchnorm_init(mid, dev),
                    "conv3": nn.conv_init(generator, 1, 1, mid, out_ch),
                    "bn3": nn.batchnorm_init(out_ch, dev)}
            else:
                block = {
                    "conv1": nn.conv_init(generator, 3, 3, in_ch, mid),
                    "bn1": nn.batchnorm_init(mid, dev),
                    "conv2": nn.conv_init(generator, 3, 3, mid, out_ch),
                    "bn2": nn.batchnorm_init(out_ch, dev)}
            if in_ch != out_ch or stride != 1:
                block["proj_conv"] = nn.conv_init(generator, 1, 1, in_ch,
                                                  out_ch)
                block["proj_bn"] = nn.batchnorm_init(out_ch, dev)
            stage.append(block)
            in_ch = out_ch
        params["stages"].append(stage)
    params["head"] = {"fc": nn.dense_init(generator, in_ch, num_classes)}
    return params


def _bn(params, x, train, stats, path, dtype):
    y, new = nn.batchnorm(params, x, train, dtype=dtype)
    if new is not None:
        stats[path] = new
    return y


def apply(params: Dict, x: torch.Tensor, train: bool = True,
          dtype: torch.dtype = torch.bfloat16
          ) -> Tuple[torch.Tensor, Dict]:
    """x: ``[B, H, W, 3]`` NHWC. Returns (fp32 logits ``[B, classes]``,
    BN stats updates). The head runs in fp32, as in the reference."""
    bottleneck = "conv3" in params["stages"][0][0]
    stats: Dict = {}
    relu = torch.relu

    y = nn.conv2d(params["stem"]["conv"], x, stride=2, dtype=dtype)
    y = relu(_bn(params["stem"]["bn"], y, train, stats, "stem/bn", dtype))
    y = nn.max_pool(y, 3, 2)

    for si, stage in enumerate(params["stages"]):
        for bi, block in enumerate(stage):
            stride = 2 if (si > 0 and bi == 0) else 1
            shortcut = y
            p = "stages/%d/%d" % (si, bi)
            if bottleneck:
                z = nn.conv2d(block["conv1"], y, dtype=dtype)
                z = relu(_bn(block["bn1"], z, train, stats, p + "/bn1", dtype))
                z = nn.conv2d(block["conv2"], z, stride=stride, dtype=dtype)
                z = relu(_bn(block["bn2"], z, train, stats, p + "/bn2", dtype))
                z = nn.conv2d(block["conv3"], z, dtype=dtype)
                z = _bn(block["bn3"], z, train, stats, p + "/bn3", dtype)
            else:
                z = nn.conv2d(block["conv1"], y, stride=stride, dtype=dtype)
                z = relu(_bn(block["bn1"], z, train, stats, p + "/bn1", dtype))
                z = nn.conv2d(block["conv2"], z, dtype=dtype)
                z = _bn(block["bn2"], z, train, stats, p + "/bn2", dtype)
            if "proj_conv" in block:
                shortcut = nn.conv2d(block["proj_conv"], y, stride=stride,
                                     dtype=dtype)
                shortcut = _bn(block["proj_bn"], shortcut, train, stats,
                               p + "/proj_bn", dtype)
            y = relu(z + shortcut)

    pooled = nn.global_avg_pool(y)
    tile = collectives.moe_split().tile("head/fc/kernel")
    if tile is None:
        logits = nn.dense(params["head"]["fc"], pooled, dtype=torch.float32)
    else:
        fc = params["head"]["fc"]
        logits = collectives.gather_last(nn.column_dense(
            {"kernel": fc["kernel"]}, pooled, torch.float32, tile.group),
            tile) + fc["bias"].float()
    return logits, stats


@torch.no_grad()
def merge_stats(params: Dict, stats: Dict) -> Dict:
    """Fold :func:`apply`'s BN stats into the tree, in place (the
    reference builds a new tree; the port copies into the leaves so the
    optimizer's tensors keep their storage). Returns ``params``."""
    for path, new in stats.items():
        node = params
        for part in path.split("/"):
            node = node[int(part)] if part.isdigit() else node[part]
        for key, value in new.items():
            node[key].copy_(value)
    return params


def loss_fn(params: Dict, batch: Dict, train: bool = True,
            dtype: torch.dtype = torch.bfloat16):
    """batch = ``{"image": [B,H,W,3], "label": [B]}``."""
    logits, stats = apply(params, batch["image"], train=train, dtype=dtype)
    loss = nn.softmax_cross_entropy(logits, batch["label"])
    return loss, {"stats": stats,
                  "accuracy": nn.accuracy(logits, batch["label"])}


def synthetic_batch(generator: torch.Generator, batch_size: int,
                    image_size: int = 224, num_classes: int = 1000) -> Dict:
    """Random bf16 NHWC images and int32 labels, drawn from ``generator``
    on its device."""
    dev = generator.device
    image = torch.randn((batch_size, image_size, image_size, 3),
                        generator=generator, device=dev).to(torch.bfloat16)
    label = torch.randint(0, num_classes, (batch_size,), generator=generator,
                          device=dev, dtype=torch.int32)
    return {"image": image, "label": label}
