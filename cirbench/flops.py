"""Operations and bytes of the model's layers, from a configuration's shapes.

FLOPs are 2 × every multiply-add of the matrix products, convolutions
and attention a layer defines (normalizations, activations, pools and
softmax are not counted); causal attention counts the S(S + 1)/2 score
pairs it needs. Each function returns a `Work`: FLOPs by the precision
their products run in on the served model (the towers and TME in bf16,
the ERN in fp32) and the bytes of the layer's inputs, weights and
outputs, each read or written once.

Written by layer from the least-time arithmetic the port's smoke run
used for single kernels (`tower_work`, `bound`), extended to whole
layers.
"""

from __future__ import annotations

import dataclasses

BF16, FP32, UINT8 = 2, 4, 1


@dataclasses.dataclass
class Work:
    flops: dict[str, float]        # precision -> FLOPs
    bytes: float

    def __add__(self, other: "Work") -> "Work":
        keys = set(self.flops) | set(other.flops)
        return Work({k: self.flops.get(k, 0.0) + other.flops.get(k, 0.0) for k in keys},
                    self.bytes + other.bytes)

    @property
    def total_flops(self) -> float:
        return sum(self.flops.values())


# ---------------------------------------------------------------- counts


def block_flops(s: int, w: int, causal: bool = False, mlp: int = 4) -> float:
    """One pre-LN transformer block over s tokens of width w: the packed
    q/k/v projection, scores and context, the out-projection, the MLP."""
    pairs = s * (s + 1) // 2 if causal else s * s
    return 2 * s * w * 3 * w + 2 * 2 * pairs * w + 2 * s * w * w + 2 * 2 * s * w * mlp * w


def block_params(w: int, mlp: int = 4) -> int:
    return 3 * w * w + 3 * w + w * w + w + 2 * mlp * w * w + mlp * w + w + 4 * w


def vit_flops(v: dict) -> float:
    """One image through the ViT tower, every token projected."""
    g = v["image_size"] // v["patch_size"]
    s, w = g * g + 1, v["width"]
    return (2 * g * g * 3 * v["patch_size"] ** 2 * w + v["layers"] * block_flops(s, w)
            + 2 * s * w * v["embed_dim"])


def vit_params(v: dict) -> int:
    g = v["image_size"] // v["patch_size"]
    w = v["width"]
    return (3 * v["patch_size"] ** 2 * w + w + (g * g + 1) * w + 4 * w
            + v["layers"] * block_params(w) + w * v["embed_dim"])


def conv_flops(h: int, w: int, cin: int, cout: int, k: int) -> float:
    """A k x k convolution producing an h x w x cout map."""
    return 2 * h * w * cout * cin * k * k


def resnet_convs(v: dict) -> list[tuple[str, int, int, int, int, int]]:
    """(name, out h = out w, cin, cout, k, stride-before-pool) of every
    convolution of the modified ResNet, in forward order."""
    side = v["image_size"]
    width = v["width"]
    convs = [("stem.conv1", side // 2, 3, width // 2, 3, 2),
             ("stem.conv2", side // 2, width // 2, width // 2, 3, 1),
             ("stem.conv3", side // 2, width // 2, width, 3, 1)]
    side //= 4                                     # stride 2, then the 2x2 pool
    inplanes = width
    for i, blocks in enumerate(v["layers"]):
        planes = width * 2 ** i
        for j in range(blocks):
            stride = 2 if (i > 0 and j == 0) else 1
            out_side = side // stride
            pre = f"layer{i + 1}.{j}."
            convs += [(pre + "conv1", side, inplanes, planes, 1, 1),
                      (pre + "conv2", side, planes, planes, 3, 1),
                      (pre + "conv3", out_side, planes, 4 * planes, 1, 1)]
            if stride > 1 or inplanes != 4 * planes:
                convs.append((pre + "downsample", out_side, inplanes, 4 * planes, 1, 1))
            inplanes, side = 4 * planes, out_side
    return convs


def bottleneck_flops(v: dict, stage: int, index: int) -> float:
    pre = f"layer{stage}.{index}."
    return sum(conv_flops(h, h, ci, co, k) for name, h, ci, co, k, _ in resnet_convs(v)
               if name.startswith(pre))


def attnpool_flops(v: dict) -> float:
    c = v["width"] * 32
    t = (v["image_size"] // 32) ** 2 + 1
    d = v["embed_dim"]
    return (2 * c * c + 2 * 2 * t * c * c + 2 * 2 * t * c   # q, k and v, scores + context
            + 2 * c * d + 2 * t * c * d)                   # c_proj of the output and of v


def resnet_flops(v: dict) -> float:
    return sum(conv_flops(h, h, ci, co, k) for _, h, ci, co, k, _ in resnet_convs(v)
               ) + attnpool_flops(v)


def resnet_params(v: dict) -> int:
    c = v["width"] * 32
    t = (v["image_size"] // 32) ** 2 + 1
    d = v["embed_dim"]
    convs = sum(ci * co * k * k + 4 * co for _, _, ci, co, k, _ in resnet_convs(v))
    return convs + t * c + 3 * (c * c + c) + c * d + d


def text_flops(t: dict) -> float:
    s, w = t["context_length"], t["width"]
    return t["layers"] * block_flops(s, w, causal=True) + 2 * s * w * t["embed_dim"]


def text_params_read(t: dict) -> int:
    """The text tower's weights a call reads: the embedding rows of its
    tokens, the positional table, the blocks, ln_final, the projection."""
    s, w = t["context_length"], t["width"]
    return 2 * s * w + t["layers"] * block_params(w) + 2 * w + w * t["embed_dim"]


def tme_flops(d: int, s: int, p: int) -> float:
    return 2 * p * d * d + 2 * s * d * d + 2 * 2 * p * d * d + 2 * 2 * s * p * d + 2 * s * d * d


def tme_params(d: int) -> int:
    return 5 * (d * d + d) + 2 * d


def sr_flops(d: int, p: int) -> float:
    return 2 * p * d * d + 2 * d * d + 2 * p * d


def sr_params(d: int, p: int) -> int:
    return 2 * (d * d + d) + 4 * p + 4 * d + d + 1


def combiner_flops(d: int, proj: int, hidden: int) -> float:
    return 2 * 2 * d * proj * d + 2 * 2 * proj * d * hidden * d + 2 * hidden * d


def combiner_params(d: int, proj: int, hidden: int) -> int:
    return 2 * (d * proj * d + proj * d) + 2 * proj * d * hidden * d + hidden * d + hidden * d + 1


def dvr_flops(d: int, s: int, p: int, ern: dict) -> float:
    t = 1 + p + s
    inter = ern["bert_intermediate"]
    bert = ern["bert_layers"] * (2 * 3 * t * d * d + 2 * 2 * t * t * d + 2 * t * d * d
                                 + 2 * 2 * t * d * inter) + 2 * d * d
    mr = 2 * s * d * d + 2 * 2 * p * d * d + 2 * 2 * s * p * d + 2 * s * d * d
    comb = combiner_flops(d, ern["combiner_proj"], ern["combiner_hidden"])
    return bert + mr + sr_flops(d, p) + 3 * comb


def dvr_params(d: int, s: int, p: int, ern: dict) -> int:
    t = 1 + p + s
    inter = ern["bert_intermediate"]
    bert = (d + t * d + 2 * d + 2 * d + d * d + d
            + ern["bert_layers"] * (4 * (d * d + d) + 2 * d + 2 * d * inter + inter + d + 2 * d))
    mr = 4 * (d * d + d)
    return (bert + mr + sr_params(d, p)
            + 3 * combiner_params(d, ern["combiner_proj"], ern["combiner_hidden"]))


# ---------------------------------------------------------------- layers


def image_tower(config: dict, images: int) -> Work:
    """The image tower over `images` uint8 images: bf16 products; the
    images read, the bf16 weights read, globals and tokens written."""
    v = config["vision"]
    if v["kind"] == "vit":
        flops, params = vit_flops(v), vit_params(v)
        tokens = (v["image_size"] // v["patch_size"]) ** 2 + 1
    else:
        flops, params = resnet_flops(v), resnet_params(v)
        tokens = (v["image_size"] // 32) ** 2 + 1
    out = (1 + tokens) * v["embed_dim"] * BF16
    return Work({"bf16": flops * images},
                images * (v["image_size"] ** 2 * 3 * UINT8 + out) + params * BF16)


def index_refine(config: dict, rows: int) -> Work:
    """The ERN index tower over `rows` gallery items: fp32 products; the
    globals and patches read, the fp32 weights read, the rows written."""
    d, p, ern = config["vision"]["embed_dim"], config["patch_num"], config["ern"]
    comb = (ern["combiner_proj"], ern["combiner_hidden"])
    flops = sr_flops(d, p) + combiner_flops(d, *comb)
    params = sr_params(d, p) + combiner_params(d, *comb)
    return Work({"fp32": flops * rows}, rows * (d + p * d + d) * FP32 + params * FP32)


def embed_image(config: dict) -> Work:
    """One gallery item: the image tower and its refined row."""
    return image_tower(config, 1) + index_refine(config, 1)


def serve_call(config: dict, gallery: int, k: int, batch: int = 1) -> Work:
    """One serve-program call of `batch` queries: the text tower and TME
    (bf16), the DVR and the search (fp32); the ids and the reference rows
    read, the weights read once, the gallery read once, the top-k written."""
    t, d, p, ern = config["text"], config["vision"]["embed_dim"], config["patch_num"], config["ern"]
    s = t["context_length"]
    bf16 = text_flops(t) + (tme_flops(d, s, p) if config["tme"] else 0)
    fp32 = dvr_flops(d, s, p, ern) + 2 * gallery * d
    weights = ((text_params_read(t) + (tme_params(d) if config["tme"] else 0)) * BF16
               + dvr_params(d, s, p, ern) * FP32)
    per_query = s * 4 + (d + p * d) * FP32 + k * (FP32 + 8)
    return Work({"bf16": bf16 * batch, "fp32": fp32 * batch},
                weights + gallery * d * FP32 + batch * per_query)


def train_towers(config: dict, batch: int) -> Work:
    """The frozen towers of a train step of `batch` rows: two images and a
    caption a row, bf16 products; their images, ids and weights read, the
    globals and tokens written."""
    t = config["text"]
    s = t["context_length"]
    text = Work({"bf16": batch * text_flops(t)},
                batch * (s * 8 + (1 + s) * t["embed_dim"] * BF16) + text_params_read(t) * BF16)
    return image_tower(config, 2 * batch) + text


def train_step(config: dict, batch: int) -> Work:
    """One train step's model FLOPs: the frozen towers' forward, and the
    trained parts (TME, the DVR, the index tower, the loss) counted three
    times (forward, and the backward's two products a product)."""
    t, d, p, ern = config["text"], config["vision"]["embed_dim"], config["patch_num"], config["ern"]
    s = t["context_length"]
    comb = (ern["combiner_proj"], ern["combiner_hidden"])
    trained = ((tme_flops(d, s, p) if config["tme"] else 0) + dvr_flops(d, s, p, ern)
               + sr_flops(d, p) + combiner_flops(d, *comb)) * batch + 2 * batch * batch * d
    return train_towers(config, batch) + Work({"fp32": 3 * trained}, 0.0)
