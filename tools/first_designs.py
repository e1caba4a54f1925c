#!/usr/bin/env python3
"""Times the first designs of the int8 L2Norm (B3, ``csrc/l2norm.cu``) and of
VGG conv1_2 + pool (B2, ``csrc/stem.cu``), and B4 (``csrc/stem_fp.cu``, whose
conv1_2 stage B2 now shares), from an older checkout against this
checkout's kernels on one NVIDIA GPU, in turns, at the SSD-300 shapes.

    mkdir -p tmp/parent && git archive a851d31 | tar -x -C tmp/parent
    python3 tools/first_designs.py --parent tmp/parent

(a851d31 is the commit before the second designs.)

The older sources are built with this checkout's nvcc flags into
``<parent>/object_detector_tpu_torch/build/`` and called through the C
interfaces they had at a851d31 (B2 then took conv1_2's kernel as __dp4a
words [tap][cin / 4][cout]). Also builds copies of the first B3 with parts
removed (the IEEE divide a value replaced by a multiply, gamma read as
four 16-byte loads a chunk instead of one load a value, the store removed),
to show where its time went. Every output is first held bit-equal to this
checkout's kernel (the copies with parts removed are not: they compute
something else). Times are by CUDA-graph replay (``graph_ms``), in the
order old, new, new, old. Prints one JSON line a kernel and shape, and the
card's name and power limit first.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

# Text edits of the first B3 (a851d31's csrc/l2norm.cu) that remove one part.
_DIVIDE = "float code = rintf(__fdiv_rn(y, out_scale));"
_GAMMA = "gamma[base + i]);"
_STORE = ("*reinterpret_cast<int4*>(out_row + base) = make_int4(words[0], words[1], words[2], "
          "words[3]);")
_LANE = "  const int lane = threadIdx.x % 32;\n"
_WORDS = "      int words[4] = {0, 0, 0, 0};\n"
_HOISTED = ("      float g[16];\n#pragma unroll\n      for (int j = 0; j < 4; ++j) {\n"
            "        const float4 f = reinterpret_cast<const float4*>(gamma + base)[j];\n"
            "        g[4 * j] = f.x; g[4 * j + 1] = f.y; g[4 * j + 2] = f.z; g[4 * j + 3] = f.w;\n"
            "      }\n")


def l2norm_variant(src: str, multiply: bool = False, hoist: bool = False,
                   no_store: bool = False) -> str:
    for text in (_DIVIDE, _GAMMA, _STORE, _LANE, _WORDS):
        if text not in src:
            raise SystemExit(f"the older l2norm.cu is not the first design: no {text!r}")
    if multiply:
        src = src.replace(_LANE, _LANE + "  const float inv_s = __frcp_rn(out_scale);\n")
        src = src.replace(_DIVIDE, "float code = rintf(__fmul_rn(y, inv_s));")
    if hoist:
        src = src.replace(_WORDS, _WORDS + _HOISTED).replace(_GAMMA, "g[i]);")
    if no_store:  # never true at run time; the compiler cannot drop the work before it
        src = src.replace(_STORE, "if (out_scale < 0.0f) " + _STORE)
    return src


L2NORM_VARIANTS = {"first_design": {}, "multiply_not_divide": {"multiply": True},
                   "gamma_hoisted": {"hoist": True},
                   "multiply_and_gamma_hoisted": {"multiply": True, "hoist": True},
                   "no_store": {"no_store": True}}


def build_old(parent: Path, build_mod) -> dict:
    """{name: ctypes.CDLL} for the older B2, B4 and the B3 variants, built
    in parallel."""
    csrc = parent / "object_detector_tpu_torch" / "csrc"
    out_dir = parent / "object_detector_tpu_torch" / "build" / "first_designs"
    out_dir.mkdir(parents=True, exist_ok=True)
    sources = {"stem": csrc / "stem.cu", "stem_fp": csrc / "stem_fp.cu"}
    l2 = (csrc / "l2norm.cu").read_text()
    for name, kw in L2NORM_VARIANTS.items():
        path = out_dir / f"l2norm_{name}.cu"
        path.write_text(l2norm_variant(l2, **kw))
        sources[f"l2norm_{name}"] = path
    procs = {}
    for name, src in sources.items():
        lib = out_dir / f"lib{name}.so"
        cmd = [build_mod._nvcc(), *build_mod.NVCC_FLAGS, "-I", str(csrc), "-o", str(lib), str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate(timeout=900)
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed on the older {name}:\n{log}")
        libs[name] = ctypes.CDLL(str(lib))
    p, i, f, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
    for name, lib in libs.items():
        if name.startswith("l2norm"):
            lib.l2norm_requant.argtypes = [p, p, f, ll, i, p, p]
        elif name == "stem":
            lib.stem_conv12_pool.argtypes = [p, p, p, p, f, i, i, i, p, p]
        else:
            lib.stem_fused_producer.argtypes = [p, p, p, p, p, f, p, p, f, i, i, i, p, p]
    return libs


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", required=True, type=Path,
                        help="an unpacked checkout of the commit with the first designs")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    from chip_smoke import graph_ms, gpu_line
    from object_detector_tpu_torch.kernels import build, l2norm, stem, stem_fp

    print(gpu_line())
    build.build(["l2norm", "stem", "stem_fp"])
    old = build_old(args.parent.resolve(), build)
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    gen = torch.Generator(device="cuda").manual_seed(9)

    def randint(low, high, shape):
        return torch.randint(low, high, shape, generator=gen, device="cuda").to(torch.int8)

    def report(kernel, shape, calls, iters):
        """calls: {name: fn}; "new" is this checkout's wrapper. Old, new,
        new, old for the first old entry; once each for the others."""
        first = next(n for n in calls if n != "new")
        times = {n: [] for n in calls}
        for name in (first, "new", "new", first):
            times[name].append(graph_ms(torch, calls[name], iters))
        for name in calls:
            if not times[name]:
                times[name].append(graph_ms(torch, calls[name], iters))
        print(json.dumps({"kernel": kernel, "input": list(shape), "graph_ms": times}))

    for batch in (64, 1):
        q0 = randint(-127, 128, (batch, 38, 38, 512))
        gamma = torch.rand(512, generator=gen, device="cuda") * 20.0
        want = l2norm.l2norm_requant(q0, gamma, 0.137)
        out = torch.empty_like(q0)
        calls = {}
        for name in L2NORM_VARIANTS:
            lib = old[f"l2norm_{name}"]
            calls[name] = lambda lib=lib: lib.l2norm_requant(
                q0.data_ptr(), gamma.data_ptr(), 0.137, q0.numel() // 512, 512, out.data_ptr(),
                stream())
        calls["first_design"]()
        torch.cuda.synchronize()
        if not torch.equal(out, want):
            raise SystemExit("the first B3 and this checkout's differ")
        calls["new"] = lambda: l2norm.l2norm_requant(q0, gamma, 0.137)
        report("l2norm_requant", q0.shape, calls, 50)

        q1 = randint(-127, 128, (batch, 300, 300, 64))
        w2 = randint(-127, 128, (3, 3, 64, 64))
        deq = torch.rand(64, generator=gen, device="cuda") * 1e-3
        bias = torch.randn(64, generator=gen, device="cuda") * 0.1
        packed = stem.pack_weights(w2)
        words = w2.reshape(9, 16, 4, 64).permute(0, 1, 3, 2).contiguous()
        out2 = torch.empty((batch, 150, 150, 64), dtype=torch.int8, device="cuda")
        old_b2 = lambda: old["stem"].stem_conv12_pool(  # noqa: E731
            q1.data_ptr(), words.data_ptr(), deq.data_ptr(), bias.data_ptr(), 0.021, batch, 300,
            300, out2.data_ptr(), stream())
        old_b2()
        torch.cuda.synchronize()
        if not torch.equal(out2, stem.stem_conv12_pool(q1, w2, deq, bias, 0.021, packed=packed)):
            raise SystemExit("the first B2 and this checkout's differ")
        report("stem_conv12_pool", q1.shape,
               {"first_design": old_b2,
                "new": lambda: stem.stem_conv12_pool(q1, w2, deq, bias, 0.021, packed=packed)},
               10 if batch > 1 else 50)
        del q1, out2

        x_q = randint(-127, 128, (batch, 300, 300, 3))
        w1 = randint(-127, 128, (3, 3, 3, 64))
        deq1 = torch.rand(64, generator=gen, device="cuda") * 1e-3
        p1, p2 = stem_fp.pack_weights(w1, w2)
        fp_args = (x_q, w1, deq1, bias, 0.043, w2, deq, bias, 0.021)
        out4 = torch.empty((batch, 150, 150, 64), dtype=torch.int8, device="cuda")
        old_b4 = lambda: old["stem_fp"].stem_fused_producer(  # noqa: E731
            x_q.data_ptr(), p1.data_ptr(), p2.data_ptr(), deq1.data_ptr(), bias.data_ptr(), 0.043,
            deq.data_ptr(), bias.data_ptr(), 0.021, batch, 300, 300, out4.data_ptr(), stream())
        old_b4()
        torch.cuda.synchronize()
        if not torch.equal(out4, stem_fp.stem_fused_producer(*fp_args, packed=(p1, p2))):
            raise SystemExit("the parent's B4 and this checkout's differ")
        report("stem_fused_producer", x_q.shape,
               {"parent": old_b4, "new": lambda: stem_fp.stem_fused_producer(
                   *fp_args, packed=(p1, p2))}, 10 if batch > 1 else 50)
    return 0


if __name__ == "__main__":
    sys.exit(main())
