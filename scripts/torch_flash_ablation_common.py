"""What the two flash-attention ablation scripts share
(torch_flash_fwd_ablation.py and torch_flash_bwd_ablation.py, in this
directory): a kernel source's variants made by text substitution, their
build (one nvcc each, all started together), a watchdog for variants that
hang, the card's name and power limit, and the command line.  They time
with chip_smoke.time_cold_in_turn and hold outputs to the plain version
with chip_smoke.row_errs, so that the ablations measure as the smoke run
does.  Imported, not run.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import threading

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)  # the package and chip_smoke


def make_variant(name, out_root, csrc, variants, src_name, against=None):
    """The variant's sources (`src_name` and the headers) in out_root/name/,
    its substitutions applied, each to the one file where it matches once
    (for "against", the sources of `against` as they are)."""
    if name == "against":
        csrc = against
    files = [src_name] + sorted(f for f in os.listdir(csrc) if f.endswith(".cuh"))
    texts = {f: open(os.path.join(csrc, f)).read() for f in files}
    for old, new in variants.get(name, []):
        counts = {f: t.count(old) for f, t in texts.items()}
        if sum(counts.values()) != 1:
            raise SystemExit(f"{name}: the substitution of {old.splitlines()[0].strip()!r} "
                             f"matches {sum(counts.values())} times in {files}")
        f = next(f for f, c in counts.items() if c)
        texts[f] = texts[f].replace(old, new)
    d = os.path.join(out_root, name)
    os.makedirs(d, exist_ok=True)
    for f, text in texts.items():
        with open(os.path.join(d, f), "w") as fh:
            fh.write(text)
    return d


def build_variants(names, dirs, src_name):
    """{name: ctypes library}: each variant's `src_name` built by nvcc, one
    process each, all started together; None where a build failed (its
    error printed)."""
    from cluster_anywhere_tpu_torch.ops import _build

    lib_name = "lib" + src_name.replace(".cu", ".so")
    built, errors = {}, {}

    def build(n):
        so = os.path.join(dirs[n], lib_name)
        proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", so,
                               os.path.join(dirs[n], src_name)], capture_output=True, text=True)
        (built if proc.returncode == 0 else errors)[n] = so if proc.returncode == 0 else proc.stderr

    threads = [threading.Thread(target=build, args=(n,)) for n in names]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    for n, err in errors.items():
        print(f"{n}: nvcc failed\n{err[-3000:]}", file=sys.stderr)
    return None if errors else {n: ctypes.CDLL(so) for n, so in built.items()}


def start_watchdog(limit_s=300.0):
    """Ends the process with exit code 3 unless the caller stops the returned
    timer within limit_s seconds: a barrier slip in a variant hangs the card
    rather than failing.  The checks and the timing of every variant take
    well under a minute."""
    def fire():
        print(f"watchdog: the kernels did not finish in {limit_s:.0f} s; a variant hangs",
              file=sys.stderr, flush=True)
        os._exit(3)

    timer = threading.Timer(limit_s, fire)
    timer.daemon = True
    timer.start()
    return timer


def print_card():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip())


def parse_args(argv, variants):
    """(variant names, --against path or None) from the command line."""
    args = list(argv)
    against = None
    if "--against" in args:
        i = args.index("--against")
        against = os.path.abspath(args[i + 1])
        del args[i:i + 2]
    chosen = args or list(variants)
    unknown = [n for n in chosen if n not in variants]
    if unknown:
        raise SystemExit(f"unknown variants {unknown}; known: {list(variants)}")
    return chosen, against
