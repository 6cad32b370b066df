"""A/B of the MAS kernels H1, H10, H11, H13 and H14 and the MoBo
boundary kernel H8 between source trees, on one card.

    python3 kernel_ab.py [--sass] TREE [TREE ...]

Each TREE is the root of a checkout: this one, or another commit unpacked
with `git archive` into a gitignored directory of this one (for example
`aligner_tpu_torch/_build/ab/parent`). Name the trees in the order to run
them, parent first and last (parent change change parent), so that drift
in the card's clocks shows. For each, a process started from the tree's
root builds that tree's kernels and times them with CUDA events (mean of
20 calls after a warm-up, `chip_smoke.cuda_ms`), three times over:

  * H1 fused on the natural layout (tiles) and on frame-major storage read
    through a natural-shaped view (rows), and H1's forward alone
    (`mas_bits`) at B=32 and B=256, 128x1024 ragged;
  * H13 (`mas_bits(chains=2)` and `chains=4`) at B=32;
  * the walks over `mas_bits`' bytes at B=32 and B=256, 128x1024 ragged:
    H1's walk alone (`mas_backtrack`), H10 (`form="stage"`), H11 (the
    index walk, `mas_walk_idx`) and H14 (`chains=2` and `chains=4`), by
    the profiler's device time of every
    kernel a call launches (a tree's zero fill included where its walk
    needs one), beside CUDA events around the call, which at B=32 read
    the host's launch work for the call more than the card;
  * H8 (`mobo_bp`) at B=16, 64, 128, 133 and 256, 128 tokens x 1025
    positions, D=32, and at B=16, D=1; where the tree has H8's wide form
    (`_bp_plan` giving C = 0), also forced into it;

one line per tree, repetition and kernel. Inputs are `chip_smoke`'s own
(`ragged`, `mobo_inputs`), made from seeds. With --sass it first compiles
each tree's `csrc/mas.cu` for sm_90a and prints, for H1's instance on the
natural layout (`mas_kernel<1, 32, true, true>`), its instruction count
and how many times it reads the shared-memory window's base (`S2UR ...
SR_CgaCtaId`). Needs a card, and nvcc and cuobjdump for --sass.
"""
import os
import re
import subprocess
import sys
import tempfile

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-cubin")
H1_NATURAL = "mas_kernelILi1ELi32ELb1ELb1E"   # cells 1, ring 32, tiles


def sass_counts(tree):
    """(instructions, window-base reads) of H1's natural instance in the
    tree's csrc/mas.cu, compiled for sm_90a."""
    cuda = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    src = os.path.join(tree, "aligner_tpu_torch", "csrc", "mas.cu")
    with tempfile.TemporaryDirectory() as tmp:
        cubin = os.path.join(tmp, "mas.cubin")
        subprocess.run([os.path.join(cuda, "bin", "nvcc"), *NVCC_FLAGS,
                        "-o", cubin, src], check=True)
        dump = subprocess.run([os.path.join(cuda, "bin", "cuobjdump"),
                               "-sass", cubin], check=True,
                              capture_output=True, text=True).stdout
    body, keep = [], False
    for line in dump.splitlines():
        if "Function :" in line:
            keep = H1_NATURAL in line
        elif keep and re.search(r"/\*[0-9a-f]{4}\*/", line):
            body.append(line)
    return len(body), sum("SR_CgaCtaId" in line for line in body)


def forced(module, name, value, fn):
    """fn() with module.name set to value."""
    kept = getattr(module, name)
    setattr(module, name, value)
    try:
        return fn()
    finally:
        setattr(module, name, kept)


def run_tree(label):
    """The timings of the tree in the working directory."""
    sys.path.insert(0, os.getcwd())
    import torch

    import chip_smoke as cs
    from aligner_tpu_torch.ops import mas_kernel as mk
    from aligner_tpu_torch.ops import mobo_kernel as mb

    dev = torch.device("cuda", 0)
    cs.phase_build()

    def mas_inputs(B):
        return tuple(torch.from_numpy(a).to(dev)
                     for a in cs.ragged(0, B, cs.T_X, cs.T_Y))

    v, tx, ty = mas_inputs(cs.B_MAS)
    rows = v.transpose(1, 2).contiguous().transpose(1, 2)
    v2, tx2, ty2 = mas_inputs(cs.B_SERVE)
    walks = {}
    for B, (vb, txb, tyb) in ((cs.B_MAS, (v, tx, ty)),
                              (cs.B_SERVE, (v2, tx2, ty2))):
        bits = mk.mas_bits(vb, txb, tyb)
        for name, options in (("H1 walk alone", {}),
                              ("H10", {"form": "stage"}),
                              ("H14 K=2", {"chains": 2}),
                              ("H14 K=4", {"chains": 4})):
            walks[f"{name} B={B}"] = (
                lambda bits=bits, txb=txb, tyb=tyb, options=options:
                mk.mas_backtrack(bits, txb, tyb, **options))
        walks[f"H11 B={B}"] = (lambda bits=bits, txb=txb, tyb=tyb:
                               mk.mas_walk_idx(bits, txb, tyb))
    for rep in range(3):
        for name, fn in walks.items():
            ms, kernels = cs.device_ms(fn, 20)
            print(f"{label} rep {rep}: {name} {ms:.4f} ms of device time "
                  f"(kernels {kernels}), {cs.cuda_ms(fn, 20):.4f} ms by "
                  f"events", flush=True)
    runs = {
        "H1 fused, natural": lambda: mk.mas_path(v, tx, ty),
        "H1 fused, frame-major storage": lambda: mk.mas_path(rows, tx, ty),
        "H1 forward alone": lambda: mk.mas_bits(v, tx, ty),
        "H1 forward alone B=256": lambda: mk.mas_bits(v2, tx2, ty2),
        "H13 K=2": lambda: mk.mas_bits(v, tx, ty, chains=2),
        "H13 K=4": lambda: mk.mas_bits(v, tx, ty, chains=4),
    }
    plan = getattr(mb, "_bp_plan", None)

    def wide(B, T_x, n, D):
        return (0, n) + plan(B, T_x, n, D)[2:-1] + (4 * (3 * n + 4 * D),)

    for B, D in ((cs.B_OTA, cs.D_MOBO), (64, cs.D_MOBO), (128, cs.D_MOBO),
                 (133, cs.D_MOBO), (cs.B_SERVE, cs.D_MOBO), (cs.B_OTA, 1)):
        e_tm, mtx, mty = cs.mobo_inputs(dev, 15, cs.T_Y, D, B)
        runs[f"H8 B={B} D={D}"] = (
            lambda e_tm=e_tm, mtx=mtx, mty=mty, D=D:
            mb.mobo_bp(e_tm, mtx, mty, D))
        if plan is not None:
            runs[f"H8 B={B} D={D} wide form"] = (
                lambda e_tm=e_tm, mtx=mtx, mty=mty, D=D:
                forced(mb, "_bp_plan", wide,
                       lambda: mb.mobo_bp(e_tm, mtx, mty, D)))
    for rep in range(3):
        for name, fn in runs.items():
            print(f"{label} rep {rep}: {name} {cs.cuda_ms(fn, 20):.4f} ms",
                  flush=True)


def main(argv):
    if argv[:1] == ["--tree"]:
        run_tree(argv[1])
        return 0
    sass = "--sass" in argv
    trees = [t for t in argv if t != "--sass"]
    if not trees:
        print(__doc__)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    if sass:
        for tree in dict.fromkeys(trees):
            count, base = sass_counts(tree)
            print(f"{tree}: {H1_NATURAL} {count} instructions, "
                  f"{base} reads of SR_CgaCtaId", flush=True)
    me = os.path.abspath(__file__)
    for tree in trees:
        code = subprocess.run([sys.executable, me, "--tree",
                               os.path.basename(os.path.abspath(tree))],
                              cwd=tree).returncode
        if code:
            return code
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
