"""NeuraLUT circuit-level model configuration (the paper's models).

A verbatim copy of ``repro.core.nl_config``; the port keeps
its own copy of every jax-free module it needs and imports nothing of
the JAX package.

A NeuraLUT network is a sparse "circuit-level" DAG of L-LUT neurons.  Each
neuron has fan-in F, input/output bit-width beta, and hides a function:

  - kind="subnet": dense MLP of depth L, width N, skip period S  (NeuraLUT)
  - kind="linear": affine + activation                           (LogicNets)
  - kind="poly":   multivariate polynomial of degree D + act.    (PolyLUT)

``layer_widths`` excludes the input: a model over ``in_features`` inputs with
layer_widths=(256, 100, 10) has three L-LUT layers.

``LUTGraphConfig`` generalizes the linear cascade to a DAG of LUT nodes
(PolyLUT-Add / NeuraLUT-Assemble topologies): each node is a bank of
L-LUT neurons reading from named predecessor buffers (``concat`` of
their channels), optionally as an **adder tree** of ``arity`` parallel
sub-LUT branches whose beta-bit codes are summed.  With power-of-two
arity A = 2^k and one shared quantizer across the branches, the summed
code lives in exactly ``beta + k`` bits with the standard signed offset
``2^(beta+k-1)`` — downstream nodes consume it through the *same*
enumerate/dequantize sweep machinery as plain codes, which is what
keeps per-node conversion and the fused cascade kernel unchanged in
structure.  A linear cascade is the degenerate chain (every node
arity 1, reading only the previous node), and ``graph_from_chain``
round-trips the six shipped ``NeuraLUTConfig`` geometries exactly.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple

INPUT = "input"  # sentinel source name: the model's quantized inputs


class UnsupportedTopology(ValueError):
    """A chain-only consumer (RTL emitter, o-sharded layout, per-layer
    serving route, ...) was handed a non-chain ``LUTGraphConfig``."""


@dataclass(frozen=True)
class NeuraLUTConfig:
    name: str
    in_features: int
    layer_widths: Tuple[int, ...]
    num_classes: int
    beta: int  # inter-partition activation bit-width
    fan_in: int  # F
    # Hidden-function parameters.
    kind: str = "subnet"  # "subnet" | "linear" | "poly"
    depth: int = 4  # L (subnet)
    width: int = 16  # N (subnet)
    skip: int = 2  # S; 0 = no skip connections (subnet)
    degree: int = 2  # D (poly)
    # First-layer exceptions (JSC-5L: beta_0=7, F_0=2).
    beta_in: Optional[int] = None  # input-feature quantization bit-width
    fan_in_0: Optional[int] = None
    # Training details (paper §III-E).
    bn_momentum: float = 0.1
    family: str = "neuralut"

    @property
    def num_layers(self) -> int:
        return len(self.layer_widths)

    def layer_fan_in(self, idx: int) -> int:
        if idx == 0 and self.fan_in_0 is not None:
            return self.fan_in_0
        return self.fan_in

    def layer_in_bits(self, idx: int) -> int:
        """Bit-width of the inputs consumed by layer ``idx``."""
        if idx == 0 and self.beta_in is not None:
            return self.beta_in
        return self.beta

    def table_size(self, idx: int) -> int:
        """Number of entries in each L-LUT of layer ``idx`` (2^{beta*F})."""
        return 2 ** (self.layer_in_bits(idx) * self.layer_fan_in(idx))

    def graph(self) -> "LUTGraphConfig":
        """This cascade as the degenerate-chain ``LUTGraphConfig``."""
        return graph_from_chain(self)


@dataclass(frozen=True)
class LUTNodeSpec:
    """One DAG node: a bank of ``width`` L-LUT neurons.

    ``inputs`` names the source buffers (``INPUT`` or earlier nodes);
    multiple sources are concatenated channel-wise into one pool that
    every branch's connectivity indexes.  ``arity`` A > 1 makes the node
    an adder tree: A independent sub-LUT branches (own connectivity,
    hidden function, and batch-norm; ONE shared quantizer) whose beta-bit
    codes are summed into a ``beta + log2(A)``-bit output code.  The
    shared quantizer is load-bearing: a sum of differently-scaled codes
    is not a function of the summed code, so it would not be
    LUT-convertible.
    """
    name: str
    width: int
    fan_in: int
    inputs: Tuple[str, ...] = (INPUT,)
    arity: int = 1


def _log2_exact(n: int) -> int:
    k = n.bit_length() - 1
    if n <= 0 or (1 << k) != n:
        raise ValueError(f"arity must be a power of two, got {n}")
    return k


@dataclass(frozen=True)
class LUTGraphConfig:
    """A DAG of LUT nodes (PolyLUT-Add style adder trees, branched
    topologies); the chain is the degenerate case.  Field names shared
    with ``NeuraLUTConfig`` (beta, kind, depth, width, skip, degree,
    beta_in, bn_momentum) mean the same thing, applied per branch."""
    name: str
    in_features: int
    num_classes: int
    beta: int
    nodes: Tuple[LUTNodeSpec, ...] = field(default=())
    kind: str = "subnet"
    depth: int = 4
    width: int = 16
    skip: int = 2
    degree: int = 2
    beta_in: Optional[int] = None
    bn_momentum: float = 0.1
    family: str = "lutgraph"

    def __post_init__(self):
        if not self.nodes:
            raise ValueError(f"{self.name}: graph has no nodes")
        seen = {}
        for i, nd in enumerate(self.nodes):
            if nd.name == INPUT or nd.name in seen:
                raise ValueError(f"{self.name}: duplicate/reserved node "
                                 f"name {nd.name!r}")
            _log2_exact(nd.arity)
            if not nd.inputs:
                raise ValueError(f"{self.name}: node {nd.name} has no "
                                 "inputs")
            bits = set()
            for src in nd.inputs:
                if src == INPUT:
                    bits.add(self.beta_in or self.beta)
                elif src in seen:
                    bits.add(self.node_out_bits(seen[src]))
                else:
                    raise ValueError(
                        f"{self.name}: node {nd.name} reads {src!r} which "
                        "is not the input or an earlier node (nodes must "
                        "be listed in topological order)")
            if len(bits) != 1:
                raise ValueError(
                    f"{self.name}: node {nd.name} concatenates sources "
                    f"with unequal bit-widths {sorted(bits)}")
            seen[nd.name] = i
        last = self.nodes[-1]
        if last.arity != 1:
            raise ValueError(f"{self.name}: final (classifier) node must "
                             "have arity 1")
        if last.width != self.num_classes:
            raise ValueError(
                f"{self.name}: final node width {last.width} != "
                f"num_classes {self.num_classes}")

    # -- per-node geometry ------------------------------------------------
    def node_index(self, name: str) -> int:
        for i, nd in enumerate(self.nodes):
            if nd.name == name:
                return i
        raise KeyError(name)

    def node_sources(self, idx: int) -> Tuple[int, ...]:
        """Source *buffer* indices for node ``idx``: buffer 0 is the
        model input, buffer j+1 is node j's output."""
        return tuple(0 if s == INPUT else self.node_index(s) + 1
                     for s in self.nodes[idx].inputs)

    def buffer_width(self, buf: int) -> int:
        return self.in_features if buf == 0 else self.nodes[buf - 1].width

    def buffer_bits(self, buf: int) -> int:
        if buf == 0:
            return self.beta_in or self.beta
        return self.node_out_bits(buf - 1)

    def node_in_width(self, idx: int) -> int:
        """Channel-pool width node ``idx``'s connectivity indexes."""
        return sum(self.buffer_width(b) for b in self.node_sources(idx))

    def node_in_bits(self, idx: int) -> int:
        return self.buffer_bits(self.node_sources(idx)[0])

    def node_out_bits(self, idx: int) -> int:
        return self.beta + _log2_exact(self.nodes[idx].arity)

    # -- chain-compatible view (NeuraLUTConfig accessor names) ------------
    @property
    def num_layers(self) -> int:
        return len(self.nodes)

    @property
    def layer_widths(self) -> Tuple[int, ...]:
        return tuple(nd.width for nd in self.nodes)

    def layer_fan_in(self, idx: int) -> int:
        return self.nodes[idx].fan_in

    def layer_in_bits(self, idx: int) -> int:
        return self.node_in_bits(idx)

    def table_size(self, idx: int) -> int:
        """Entries per L-LUT (per branch) of node ``idx``."""
        return 2 ** (self.node_in_bits(idx) * self.nodes[idx].fan_in)

    @property
    def is_chain(self) -> bool:
        """True iff this graph is a plain linear cascade."""
        prev = INPUT
        for nd in self.nodes:
            if nd.arity != 1 or nd.inputs != (prev,):
                return False
            prev = nd.name
        return True

    def as_chain(self) -> NeuraLUTConfig:
        """The equivalent ``NeuraLUTConfig``; raises ``UnsupportedTopology``
        for non-chain graphs.  Inverse of ``graph_from_chain`` for the
        shipped geometries."""
        if not self.is_chain:
            raise UnsupportedTopology(
                f"{self.name}: not a linear cascade; chain-only consumers "
                "cannot express this topology")
        fans = [nd.fan_in for nd in self.nodes]
        fan_in = fans[-1] if len(fans) > 1 else fans[0]
        if any(f != fan_in for f in fans[1:]):
            raise UnsupportedTopology(
                f"{self.name}: per-node fan-in varies beyond the first "
                "node; NeuraLUTConfig only expresses fan_in_0")
        return NeuraLUTConfig(
            name=self.name, in_features=self.in_features,
            layer_widths=self.layer_widths, num_classes=self.num_classes,
            beta=self.beta, fan_in=fan_in, kind=self.kind,
            depth=self.depth, width=self.width, skip=self.skip,
            degree=self.degree, beta_in=self.beta_in,
            fan_in_0=fans[0] if fans[0] != fan_in else None,
            bn_momentum=self.bn_momentum, family=self.family)


def graph_from_chain(cfg: NeuraLUTConfig) -> LUTGraphConfig:
    """Express a linear cascade as the degenerate-chain graph.  Geometry
    accessors (fan-in, in-bits, table sizes) agree index-for-index with
    the source config, so conversion and the cascade kernel produce
    bit-identical results through either representation."""
    nodes = []
    prev = INPUT
    for i, w in enumerate(cfg.layer_widths):
        nodes.append(LUTNodeSpec(name=f"L{i}", width=w,
                                 fan_in=cfg.layer_fan_in(i),
                                 inputs=(prev,)))
        prev = f"L{i}"
    return LUTGraphConfig(
        name=cfg.name, in_features=cfg.in_features,
        num_classes=cfg.num_classes, beta=cfg.beta, nodes=tuple(nodes),
        kind=cfg.kind, depth=cfg.depth, width=cfg.width, skip=cfg.skip,
        degree=cfg.degree, beta_in=cfg.beta_in,
        bn_momentum=cfg.bn_momentum, family=cfg.family)


def is_graph_config(cfg) -> bool:
    return isinstance(cfg, LUTGraphConfig)
