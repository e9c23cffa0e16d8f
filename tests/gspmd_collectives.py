"""GSPMD's collectives against the port's partitioned program, for one cell
(a one-off comparison, not a test).

The JAX package partitions its decode, prefill and train programs by
compiling them under the sharding specs
(``repro.launch.dryrun.build_cell_with_cfg``; the train step at its
``TRAIN_ACCUM`` microbatches, ZeRO-1 moments); GSPMD picks the collectives.
The port writes them out (``models.model.decode_step``/``prefill`` and
``train.train_step.train_step`` with ``mesh=``). This script
lowers and compiles the JAX cell for a small mesh of forced host devices in
a subprocess (the JAX tools set ``XLA_FLAGS`` when imported), reads the
compiled program's collectives (``collective_bytes_from_hlo``, and each
collective op's result shape), and counts the port's program on the same
mesh on ``meta`` over a ``fake`` group (``launch.dryrun.
collective_bytes_from_program``). Both in bytes per rank, an all-reduce
counted 2x.

    PYTHONPATH=src python tests/gspmd_collectives.py [--arch llama3-8b] \\
        [--shape decode_32k] [--mesh 2,2] [--full]

(``--full``: the full-width config; default its smoke config.) With
``--shape train_4k`` the JAX side compiles the whole train step (the
accumulation scan's body read once, as the JAX dry run reads it), and the
port's count is one step with every microbatch and recompute.
"""
import argparse
import json
import math
import os
import subprocess
import sys

JAX_SIDE = r"""
import json, re, sys
import numpy as np
from repro.launch import dryrun as D          # sets XLA_FLAGS first
import jax
from jax.sharding import Mesh
from repro.configs import get_config

arch, shape, smoke = sys.argv[1], sys.argv[2], sys.argv[4] == "1"
dims = tuple(map(int, sys.argv[3].split(",")))
cfg = get_config(arch, smoke=smoke)
mesh = Mesh(np.array(jax.devices()[:int(np.prod(dims))]).reshape(dims), ("data", "model"))
fn, args, in_sh, out_sh = D.build_cell_with_cfg(cfg, shape, mesh)
with mesh:
    compiled = jax.jit(fn, in_shardings=in_sh, out_shardings=out_sh).lower(*args).compile()
text = compiled.as_text()
ops = []
for line in text.splitlines():
    m = re.search(r"=\s+(.*?)\s+(all-reduce|all-gather|reduce-scatter|all-to-all|"
                  r"collective-permute)(-start)?\(", line.strip())
    if m:
        ops.append([m.group(2), m.group(1)])
print(json.dumps({"collectives": D.collective_bytes_from_hlo(text), "ops": ops}))
"""


def jax_side(arch: str, shape: str, dims: tuple, smoke: bool) -> dict:
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", JAX_SIDE, arch, shape,
                          ",".join(map(str, dims)), "1" if smoke else "0"],
                         env=env, capture_output=True, text=True, check=True, timeout=1800)
    return json.loads(out.stdout.strip().splitlines()[-1])


def port_side(arch: str, shape: str, dims: tuple, smoke: bool) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import counting_mesh

    with counting_mesh(dims, ("data", "model")) as mesh:
        cfg = get_config(arch, smoke=smoke)
        assert dryrun.program_covers(cfg, shape, mesh)
        return dryrun.collective_bytes_from_program(cfg, shape, mesh)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--shape", default="decode_32k")
    ap.add_argument("--mesh", default="2,2")
    ap.add_argument("--full", action="store_true")
    args = ap.parse_args()
    dims = tuple(int(n) for n in args.mesh.split(","))
    assert len(dims) == 2 and math.prod(dims) > 1
    smoke = not args.full
    print(json.dumps({"arch": args.arch, "smoke": smoke, "shape": args.shape, "mesh": dims,
                      "gspmd": jax_side(args.arch, args.shape, dims, smoke),
                      "port": port_side(args.arch, args.shape, dims, smoke)}, indent=1))


if __name__ == "__main__":
    main()
