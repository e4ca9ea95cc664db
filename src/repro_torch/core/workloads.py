"""ML workload graphs for the NPU simulator (§6's benchmark set).

Each workload is a DAG of layers.  A layer carries the quantities the
simulator needs: MACs (multiply-accumulates), weight bytes, output-activation
bytes.  Edges carry the activation bytes that flow between layers — crossing
a core boundary turns them into NoC (or global-memory) traffic.

The set follows the paper: ResNet-18/34/50 [33], GPT2 small/medium/large,
BERT [15], MobileNet [34], AlexNet [42], GoogLeNet [66], YOLO-lite [35],
plus a generic "Transformer" used in Figs. 15/16.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

DTYPE_BYTES = 2  # bf16 weights/activations


@dataclasses.dataclass
class Layer:
    name: str
    macs: int               # multiply-accumulates (flops = 2*macs)
    weight_bytes: int
    out_bytes: int
    kind: str = "conv"      # conv | matmul | dwconv | norm | pool
    reduce_out: bool = False  # tensor-parallel: output needs an all-reduce


@dataclasses.dataclass
class WorkloadGraph:
    name: str
    layers: List[Layer]
    edges: List[Tuple[int, int]]   # (src layer idx, dst layer idx)

    @property
    def total_macs(self) -> int:
        return sum(l.macs for l in self.layers)

    @property
    def total_weight_bytes(self) -> int:
        return sum(l.weight_bytes for l in self.layers)

    def successors(self, i: int) -> List[int]:
        return [b for a, b in self.edges if a == i]


# ---------------------------------------------------------------------------
# layer constructors
# ---------------------------------------------------------------------------

def conv(name: str, h: int, w: int, cin: int, cout: int, k: int,
         stride: int = 1, dw: bool = False) -> Layer:
    ho, wo = h // stride, w // stride
    if dw:
        macs = ho * wo * cin * k * k
        wbytes = cin * k * k * DTYPE_BYTES
        cout = cin
    else:
        macs = ho * wo * cout * cin * k * k
        wbytes = cin * k * k * cout * DTYPE_BYTES
    return Layer(name, macs, wbytes, ho * wo * cout * DTYPE_BYTES,
                 kind="dwconv" if dw else "conv")


def fc(name: str, din: int, dout: int, tokens: int = 1) -> Layer:
    return Layer(name, tokens * din * dout, din * dout * DTYPE_BYTES,
                 tokens * dout * DTYPE_BYTES, kind="matmul")


def _chain_edges(n: int) -> List[Tuple[int, int]]:
    return [(i, i + 1) for i in range(n - 1)]


# ---------------------------------------------------------------------------
# CNNs
# ---------------------------------------------------------------------------

def _resnet(name: str, block_counts: Sequence[int], bottleneck: bool) -> WorkloadGraph:
    layers: List[Layer] = [conv("stem", 224, 224, 3, 64, 7, stride=2)]
    edges: List[Tuple[int, int]] = []
    h = w = 56
    cin = 64
    widths = [64, 128, 256, 512]
    prev = 0
    for stage, (blocks, width) in enumerate(zip(block_counts, widths)):
        for b in range(blocks):
            stride = 2 if (b == 0 and stage > 0) else 1
            h2, w2 = h // stride, w // stride
            block_start = len(layers)
            if bottleneck:
                cout = width * 4
                layers.append(conv(f"s{stage}b{b}c1", h, w, cin, width, 1, stride))
                layers.append(conv(f"s{stage}b{b}c2", h2, w2, width, width, 3))
                layers.append(conv(f"s{stage}b{b}c3", h2, w2, width, cout, 1))
                edges += [(prev, block_start), (block_start, block_start + 1),
                          (block_start + 1, block_start + 2)]
                # skip connection: prev -> block output
                edges.append((prev, block_start + 2))
                prev = block_start + 2
            else:
                cout = width
                layers.append(conv(f"s{stage}b{b}c1", h, w, cin, width, 3, stride))
                layers.append(conv(f"s{stage}b{b}c2", h2, w2, width, width, 3))
                edges += [(prev, block_start), (block_start, block_start + 1)]
                edges.append((prev, block_start + 1))  # skip
                prev = block_start + 1
            cin = cout
            h, w = h2, w2
    head = len(layers)
    layers.append(fc("fc", cin, 1000))
    edges.append((prev, head))
    return WorkloadGraph(name, layers, edges)


def resnet18() -> WorkloadGraph:
    return _resnet("resnet18", [2, 2, 2, 2], bottleneck=False)


def resnet34() -> WorkloadGraph:
    return _resnet("resnet34", [3, 4, 6, 3], bottleneck=False)


def resnet50() -> WorkloadGraph:
    return _resnet("resnet50", [3, 4, 6, 3], bottleneck=True)


def mobilenet() -> WorkloadGraph:
    cfg = [(32, 64, 1), (64, 128, 2), (128, 128, 1), (128, 256, 2),
           (256, 256, 1), (256, 512, 2)] + [(512, 512, 1)] * 5 + \
          [(512, 1024, 2), (1024, 1024, 1)]
    layers = [conv("stem", 224, 224, 3, 32, 3, stride=2)]
    h = w = 112
    for i, (cin, cout, s) in enumerate(cfg):
        layers.append(conv(f"dw{i}", h, w, cin, cin, 3, stride=s, dw=True))
        h, w = h // s, w // s
        layers.append(conv(f"pw{i}", h, w, cin, cout, 1))
    layers.append(fc("fc", 1024, 1000))
    return WorkloadGraph("mobilenet", layers, _chain_edges(len(layers)))


def alexnet() -> WorkloadGraph:
    layers = [
        conv("c1", 224, 224, 3, 96, 11, stride=4),
        conv("c2", 27, 27, 96, 256, 5),
        conv("c3", 13, 13, 256, 384, 3),
        conv("c4", 13, 13, 384, 384, 3),
        conv("c5", 13, 13, 384, 256, 3),
        fc("f6", 256 * 6 * 6, 4096),
        fc("f7", 4096, 4096),
        fc("f8", 4096, 1000),
    ]
    return WorkloadGraph("alexnet", layers, _chain_edges(len(layers)))


def googlenet() -> WorkloadGraph:
    """Inception modules — branches expose graph-structure sensitivity."""
    layers: List[Layer] = [conv("stem1", 224, 224, 3, 64, 7, stride=2),
                           conv("stem2", 56, 56, 64, 192, 3)]
    edges: List[Tuple[int, int]] = [(0, 1)]
    prev = 1
    incep = [  # (h, cin, b1, b3r, b3, b5r, b5, pp)
        (28, 192, 64, 96, 128, 16, 32, 32),
        (28, 256, 128, 128, 192, 32, 96, 64),
        (14, 480, 192, 96, 208, 16, 48, 64),
        (14, 512, 160, 112, 224, 24, 64, 64),
        (14, 512, 128, 128, 256, 24, 64, 64),
        (14, 512, 112, 144, 288, 32, 64, 64),
        (14, 528, 256, 160, 320, 32, 128, 128),
        (7, 832, 256, 160, 320, 32, 128, 128),
        (7, 832, 384, 192, 384, 48, 128, 128),
    ]
    for m, (h, cin, b1, b3r, b3, b5r, b5, pp) in enumerate(incep):
        branch_outs = []
        i0 = len(layers)
        layers.append(conv(f"i{m}b1", h, h, cin, b1, 1)); edges.append((prev, i0))
        branch_outs.append(i0)
        i1 = len(layers)
        layers.append(conv(f"i{m}b3r", h, h, cin, b3r, 1)); edges.append((prev, i1))
        layers.append(conv(f"i{m}b3", h, h, b3r, b3, 3)); edges.append((i1, i1 + 1))
        branch_outs.append(i1 + 1)
        i2 = len(layers)
        layers.append(conv(f"i{m}b5r", h, h, cin, b5r, 1)); edges.append((prev, i2))
        layers.append(conv(f"i{m}b5", h, h, b5r, b5, 5)); edges.append((i2, i2 + 1))
        branch_outs.append(i2 + 1)
        i3 = len(layers)
        layers.append(conv(f"i{m}pp", h, h, cin, pp, 1)); edges.append((prev, i3))
        branch_outs.append(i3)
        # concat node: model as a cheap norm layer gathering the branches
        cat = len(layers)
        cout = b1 + b3 + b5 + pp
        layers.append(Layer(f"i{m}cat", 0, 0, h * h * cout * DTYPE_BYTES, kind="norm"))
        for b in branch_outs:
            edges.append((b, cat))
        prev = cat
    head = len(layers)
    layers.append(fc("fc", 1024, 1000))
    edges.append((prev, head))
    return WorkloadGraph("googlenet", layers, edges)


def yolo_lite() -> WorkloadGraph:
    layers = [
        conv("c1", 224, 224, 3, 16, 3, stride=2),
        conv("c2", 112, 112, 16, 32, 3, stride=2),
        conv("c3", 56, 56, 32, 64, 3, stride=2),
        conv("c4", 28, 28, 64, 128, 3, stride=2),
        conv("c5", 14, 14, 128, 128, 3),
        conv("c6", 14, 14, 128, 256, 3),
        conv("c7", 14, 14, 256, 125, 1),
    ]
    return WorkloadGraph("yolo_lite", layers, _chain_edges(len(layers)))


# ---------------------------------------------------------------------------
# transformers
# ---------------------------------------------------------------------------

def _transformer(name: str, n_layers: int, d: int, seq: int,
                 d_ff_mult: int = 4, vocab: int = 50257) -> WorkloadGraph:
    layers: List[Layer] = [Layer("embed", seq * d, vocab * d * DTYPE_BYTES,
                                 seq * d * DTYPE_BYTES, kind="matmul")]
    for i in range(n_layers):
        qkv = Layer(f"l{i}.qkv", seq * d * 3 * d, 3 * d * d * DTYPE_BYTES,
                    seq * 3 * d * DTYPE_BYTES, kind="matmul")
        attn = Layer(f"l{i}.attn", 2 * seq * seq * d, 0,
                     seq * d * DTYPE_BYTES, kind="matmul")
        # tensor parallelism reduces at the two residual-add boundaries:
        # attention output projection and MLP down projection
        proj = Layer(f"l{i}.proj", seq * d * d, d * d * DTYPE_BYTES,
                     seq * d * DTYPE_BYTES, kind="matmul", reduce_out=True)
        up = Layer(f"l{i}.up", seq * d * d_ff_mult * d,
                   d_ff_mult * d * d * DTYPE_BYTES,
                   seq * d_ff_mult * d * DTYPE_BYTES, kind="matmul")
        down = Layer(f"l{i}.down", seq * d_ff_mult * d * d,
                     d_ff_mult * d * d * DTYPE_BYTES,
                     seq * d * DTYPE_BYTES, kind="matmul", reduce_out=True)
        layers += [qkv, attn, proj, up, down]
    head = fc("lm_head", d, vocab, tokens=seq)
    head.reduce_out = True
    layers.append(head)
    return WorkloadGraph(name, layers, _chain_edges(len(layers)))


def gpt2_small(seq: int = 1024) -> WorkloadGraph:
    return _transformer("gpt2_small", 12, 768, seq)


def gpt2_medium(seq: int = 1024) -> WorkloadGraph:
    return _transformer("gpt2_medium", 24, 1024, seq)


def gpt2_large(seq: int = 1024) -> WorkloadGraph:
    return _transformer("gpt2_large", 36, 1280, seq)


def bert_base(seq: int = 384) -> WorkloadGraph:
    return _transformer("bert_base", 12, 768, seq, vocab=30522)


def transformer_generic(seq: int = 512) -> WorkloadGraph:
    return _transformer("transformer", 6, 512, seq, vocab=32000)


REGISTRY = {
    "resnet18": resnet18,
    "resnet34": resnet34,
    "resnet50": resnet50,
    "mobilenet": mobilenet,
    "alexnet": alexnet,
    "googlenet": googlenet,
    "yolo_lite": yolo_lite,
    "gpt2_small": gpt2_small,
    "gpt2_medium": gpt2_medium,
    "gpt2_large": gpt2_large,
    "bert_base": bert_base,
    "transformer": transformer_generic,
}


def get_workload(name: str) -> WorkloadGraph:
    try:
        return REGISTRY[name]()
    except KeyError:
        raise KeyError(f"unknown workload {name!r}; have {sorted(REGISTRY)}")


# ---------------------------------------------------------------------------
# layer -> core partitioning (pipeline mapping)
# ---------------------------------------------------------------------------

def partition_layers(graph: WorkloadGraph, n_cores: int,
                     cost: Optional[callable] = None) -> List[int]:
    """Contiguous pipeline partition balanced by ``cost`` (default: MACs):
    returns core index per layer (topological order == layer order by
    construction).
    """
    if n_cores <= 0:
        raise ValueError("n_cores must be positive")
    cost = cost or (lambda l: l.macs)
    costs = [cost(l) for l in graph.layers]
    total = sum(costs)
    target = total / n_cores
    out: List[int] = []
    core, acc = 0, 0
    remaining = total
    for i, layer in enumerate(graph.layers):
        out.append(core)
        acc += costs[i]
        remaining -= costs[i]
        cores_left = n_cores - core - 1
        if acc >= target and cores_left > 0 and remaining > 0:
            core += 1
            acc = 0
            target = remaining / max(cores_left, 1)
    return out
