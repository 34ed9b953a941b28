"""Compares the compiled kernels of this checkout of the port with another
checkout's, on a machine with the CUDA toolkit:

    python3 grouptraj_torch/sass_diff.py --root OTHER

``--root`` is the directory that holds the other checkout's
``grouptraj_torch/``. Both checkouts' libraries are built (each in its own
``_build/``) and disassembled with ``cuobjdump -sass``; a kernel's body is
its instructions with the addresses, the encodings and the mangled names
stripped. Per library it prints one JSON line: how many kernels each side
has and which of the other checkout's kernels have no identical body
here. After a change that only adds kernels (a new template instance, a
header edit that renames the anonymous namespace) that list is empty.
"""

import argparse
import collections
import hashlib
import importlib.util
import json
import os
import re
import subprocess

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _builder(root):
    """The ``ops/_build.py`` module of the checkout at ``root``."""
    path = os.path.join(root, "grouptraj_torch", "ops", "_build.py")
    spec = importlib.util.spec_from_file_location("checkout_build", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def kernel_bodies(cuobjdump, library):
    """{mangled kernel name: sha256 of its normalised SASS}."""
    sass = subprocess.run([cuobjdump, "-sass", str(library)],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    bodies, name = collections.defaultdict(list), None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
        elif name and re.match(r"\s+/\*[0-9a-f]{4,}\*/", line):
            ins = re.sub(r"/\*[0-9a-f]{4,}\*/|/\* 0x[0-9a-f]+ \*/", "", line)
            bodies[name].append(" ".join(re.sub(r"_Z\w+", "SYM",
                                                ins).split()))
    return {n: hashlib.sha256("\n".join(b).encode()).hexdigest()
            for n, b in bodies.items()}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", required=True,
                    help="the other checkout (holds grouptraj_torch/)")
    args = ap.parse_args()
    mine, other = _builder(HERE), _builder(os.path.abspath(args.root))
    libs, other_libs = mine.build(), other.build()
    cuobjdump = os.path.join(os.path.dirname(mine.nvcc_path()), "cuobjdump")
    for name in sorted(set(libs) & set(other_libs)):
        here = collections.Counter(kernel_bodies(cuobjdump,
                                                 libs[name]).values())
        theirs = kernel_bodies(cuobjdump, other_libs[name])
        print(json.dumps({
            "library": name, "kernels_other": len(theirs),
            "kernels_here": sum(here.values()),
            "other_kernels_changed": sorted(
                n for n, h in theirs.items() if here[h] == 0)}))


if __name__ == "__main__":
    main()
