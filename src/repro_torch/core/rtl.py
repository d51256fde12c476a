"""Verilog RTL generation (paper §III-E.3; port of ``repro.core.rtl``).

A copy of the JAX package's module, jax-free as it is there: the text
it writes is the reference's byte for byte.  It takes the port's tables
and statics: each table a (O, T) array or tensor of codes (the uint16
tables of ``truth_table.convert`` / a ``ServeBundle``, or int32; the hex
width comes from ``cfg.beta``, never from the dtype; packed tables are
unpacked first through ``lut_infer.unpack_tables``) and each ``conn``
a numpy array or a tensor, moved to the host once.  The connectivity
must be the one the tables were converted with: ``model_static`` draws
it from Python's salted ``hash``, so it does not reproduce across
processes.

Each L-LUT layer becomes a module of per-neuron ROMs (registered case
statements — synthesis maps these to LUT/F7/F8 trees on the target FPGA);
the top module chains layers through pipeline registers, one clock per
layer, exactly the paper's latency model.

``simulate_verilog_rom`` re-parses an emitted module and replays it in
Python — used by tests to prove the emitted RTL matches the truth tables
bit-for-bit without a Verilog simulator.

ROM bodies are emitted with numpy batch hex-formatting (a per-digit
nibble lookup viewed as fixed-width strings) instead of a Python loop
over every table entry, and ``generate_top`` streams the module chunks
to disk instead of concatenating one giant string — O(hex digits)
vectorized passes per ROM, not O(2^{beta*F}) interpreter iterations.
"""
from __future__ import annotations

import re
from pathlib import Path
from typing import Dict, Iterator, List

import numpy as np

from repro_torch.core.nl_config import (NeuraLUTConfig, UnsupportedTopology,
                                        is_graph_config)

_HEX_CHARS = np.array(list("0123456789abcdef"))


def _host(a) -> np.ndarray:
    """A numpy array of ``a`` (a tensor is detached and copied to the
    host; an array is taken as it is)."""
    if hasattr(a, "detach"):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _vhex(vals: np.ndarray, digits: int) -> np.ndarray:
    """Vectorized lowercase zero-padded hex: (n,) uints -> (n,) '<U{d}'.

    One nibble-lookup pass per hex digit; the (n, digits) char matrix is
    reinterpreted as fixed-width strings without copying per entry.
    """
    vals = np.asarray(vals, np.int64)
    shifts = 4 * np.arange(digits - 1, -1, -1, dtype=np.int64)
    chars = np.ascontiguousarray(
        _HEX_CHARS[(vals[:, None] >> shifts[None, :]) & 0xF])
    return chars.view(f"<U{digits}").ravel()


def _rom_case_lines(name: str, addr_bits: int, out_bits: int,
                    table: np.ndarray) -> List[str]:
    """One ROM module as a list of text chunks (vectorized body)."""
    addrs = _vhex(np.arange(len(table)), (addr_bits + 3) // 4)
    datas = _vhex(table, (out_bits + 3) // 4)
    entries = np.char.add(
        np.char.add(f"      {addr_bits}'h", addrs),
        np.char.add(np.char.add(f": data <= {out_bits}'h", datas), ";"))
    return [
        f"module {name} (input clk, input [{addr_bits-1}:0] addr,\n"
        f"               output reg [{out_bits-1}:0] data);\n"
        "  always @(posedge clk) begin\n"
        "    case (addr)\n",
        "\n".join(entries.tolist()),
        "\n    endcase\n  end\nendmodule\n",
    ]


def _rom_case(name: str, addr_bits: int, out_bits: int,
              table: np.ndarray) -> str:
    return "".join(_rom_case_lines(name, addr_bits, out_bits, table))


def _iter_layer_chunks(cfg: NeuraLUTConfig, idx: int, table: np.ndarray,
                       conn: np.ndarray) -> Iterator[str]:
    """One layer's Verilog as a stream of text chunks (ROMs, then the
    layer module) — ``generate_top`` writes them straight to disk
    without materializing the multi-MB layer file as one string."""
    beta_in = cfg.layer_in_bits(idx)
    beta_out = cfg.beta
    f = cfg.layer_fan_in(idx)
    o, t = table.shape
    addr_bits = beta_in * f
    in_width = int(conn.max()) + 1 if conn.size else 0
    for n in range(o):
        yield from _rom_case_lines(f"rom_l{idx}_n{n}", addr_bits,
                                   beta_out, table[n])
        yield "\n"
    body = [
        f"module layer{idx} (input clk,",
        f"    input [{beta_in * in_width - 1}:0] in_bus,",
        f"    output [{beta_out * o - 1}:0] out_bus);",
    ]
    for n in range(o):
        sel = []
        for j in range(f):
            src = int(conn[n, j])
            hi = beta_in * (src + 1) - 1
            lo = beta_in * src
            sel.append(f"in_bus[{hi}:{lo}]")
        addr = "{" + ", ".join(sel) + "}"
        body.append(f"  wire [{beta_out-1}:0] d{n};")
        body.append(f"  rom_l{idx}_n{n} u{n} (.clk(clk), .addr({addr}), "
                    f".data(d{n}));")
    outs = ", ".join(f"d{n}" for n in reversed(range(o)))
    body.append(f"  assign out_bus = {{{outs}}};")
    body.append("endmodule\n")
    yield "\n".join(body)


def generate_layer(cfg: NeuraLUTConfig, idx: int, table,
                   conn) -> str:
    """One layer: ROM per neuron + input wiring from the layer bus."""
    return "".join(_iter_layer_chunks(cfg, idx, _host(table), _host(conn)))


def generate_top(cfg, tables: List[np.ndarray],
                 statics: List[Dict], out_dir: str) -> List[str]:
    """Write layer files + top module; returns file paths.

    The top module chains layers through one linear pipeline bus, so a
    ``LUTGraphConfig`` is accepted only when its topology is a
    degenerate chain (its single-branch operands are unwrapped to the
    legacy per-layer form); a real DAG raises ``UnsupportedTopology``
    here rather than emitting wiring that silently drops fan-out edges.
    """
    if is_graph_config(cfg):
        if not cfg.is_chain:
            raise UnsupportedTopology(
                f"generate_top emits a linear layer pipeline; config "
                f"'{cfg.name}' is a LUT DAG (adder branches / fan-out) "
                f"— per-node RTL emission is not implemented")
        tables = [t[0] if isinstance(t, (list, tuple)) else t
                  for t in tables]
        statics = [{"conn": s["conns"][0] if "conns" in s else s["conn"]}
                   for s in statics]
    tables = [_host(t) for t in tables]
    statics = [{"conn": _host(s["conn"])} for s in statics]
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    paths = []
    for i, tbl in enumerate(tables):
        p = out / f"layer{i}.v"
        with p.open("w") as fh:
            fh.writelines(_iter_layer_chunks(cfg, i, tbl,
                                             statics[i]["conn"]))
        paths.append(str(p))

    beta_in0 = cfg.layer_in_bits(0)
    widths = [cfg.in_features] + list(cfg.layer_widths)
    top = [
        "module neuralut_top (input clk,",
        f"    input [{beta_in0 * cfg.in_features - 1}:0] in_bus,",
        f"    output [{cfg.beta * cfg.layer_widths[-1] - 1}:0] out_bus);",
    ]
    prev = "in_bus"
    for i in range(cfg.num_layers):
        w = cfg.beta * widths[i + 1]
        top.append(f"  wire [{w - 1}:0] bus{i};")
        top.append(f"  layer{i} l{i} (.clk(clk), .in_bus({prev}), "
                   f".out_bus(bus{i}));")
        prev = f"bus{i}"
    top.append(f"  assign out_bus = {prev};")
    top.append("endmodule\n")
    p = out / "top.v"
    p.write_text("\n".join(top))
    paths.append(str(p))
    return paths


# ---------------------------------------------------------------------------
# RTL re-simulation (test oracle)


def simulate_verilog_rom(text: str, module: str, addrs: np.ndarray
                         ) -> np.ndarray:
    """Replay one ROM module's case statement for the given addresses."""
    m = re.search(rf"module {re.escape(module)} .*?endmodule", text, re.S)
    if not m:
        raise KeyError(module)
    body = m.group(0)
    table: Dict[int, int] = {}
    for am, dm in re.findall(r"(\d+'h[0-9a-f]+):\s*data <= (\d+'h[0-9a-f]+);",
                             body):
        a = int(am.split("'h")[1], 16)
        d = int(dm.split("'h")[1], 16)
        table[a] = d
    return np.array([table[int(a)] for a in addrs], np.int64)
