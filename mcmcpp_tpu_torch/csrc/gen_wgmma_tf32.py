"""Write ``wgmma_tf32.cuh``: one wrapper per width N of Hopper's
``wgmma.mma_async.sync.aligned.m64nNk8.f32.tf32.tf32`` with A from registers.

The instruction names each of its N/2 accumulator registers in its operand
list, so every width is its own inline-assembly statement; this script writes
them out for the widths the wide kernel instantiates. Run it from anywhere:
``python mcmcpp_tpu_torch/csrc/gen_wgmma_tf32.py`` rewrites the header beside
it.
"""

from pathlib import Path

WIDTHS = (32, 40, 48, 56, 64, 72, 80, 88, 96, 112, 128)

HEAD = """\
// Generated by gen_wgmma_tf32.py: do not edit by hand.
//
// wgmma_tf32<N>(d, a, desc_b, scale_d): one
// wgmma.mma_async.sync.aligned.m64nNk8.f32.tf32.tf32 of a warpgroup, A (64 x 8)
// from registers, B (8 x N, K-major) from shared memory through desc_b:
// d = a·b + (scale_d ? d : 0). Thread (g, t) = (lane / 4, lane % 4) of warp w
// of the warpgroup holds A's rows 16w + g and 16w + g + 8 at columns t and
// t + 4 (a[0] = (g, t), a[1] = (g + 8, t), a[2] = (g, t + 4), a[3] = (g + 8,
// t + 4)), and d[4j .. 4j + 3] = S at rows 16w + g (d[4j], d[4j + 1]) and
// 16w + g + 8 (d[4j + 2], d[4j + 3]), columns 8j + 2t and 8j + 2t + 1.
// Asynchronous: issue between wgmma_fence() and wgmma_commit(), and read d
// only after wgmma_wait<0>().

#pragma once

#include <cstdint>

namespace mcmcpp {

template <int N>
struct WgmmaTf32;

template <int N>
__device__ __forceinline__ void wgmma_tf32(float (&d)[N / 2],
                                           const unsigned (&a)[4],
                                           uint64_t desc_b, int scale_d) {
  WgmmaTf32<N>::run(d, a, desc_b, scale_d);
}
"""

TAIL = """
}  // namespace mcmcpp
"""


def wrapper(n):
    r = n // 2
    regs = ", ".join(f"%{i}" for i in range(r))
    outs = ", ".join(f'"+f"(d[{i}])' for i in range(r))
    lines = [
        "",
        "template <>",
        f"struct WgmmaTf32<{n}> {{",
        f"  static __device__ __forceinline__ void run(float (&d)[{r}],",
        "                                             const unsigned (&a)[4],",
        "                                             uint64_t desc_b,",
        "                                             int scale_d) {",
        "    asm volatile(",
        '        "{\\n.reg .pred p;\\n"',
        f'        "setp.ne.b32 p, %{r + 5}, 0;\\n"',
        f'        "wgmma.mma_async.sync.aligned.m64n{n}k8.f32.tf32.tf32 "',
    ]
    # the accumulator list, twelve registers a line
    joined = regs.split(", ")
    row = []
    for i in range(0, len(joined), 12):
        row.append(", ".join(joined[i:i + 12]))
    lines.append('        "{"')
    for i, part in enumerate(row):
        sep = ", " if i < len(row) - 1 else ""
        lines.append(f'        "{part}{sep}"')
    lines.append(f'        "}}, {{%{r}, %{r + 1}, %{r + 2}, %{r + 3}}}, %{r + 4}, '
                 f'p, 1, 1;\\n}}\\n"')
    out_rows = outs.split(", ")
    lines.append("        : " + ", ".join(out_rows[:4]) + ("," if r > 4 else ""))
    for i in range(4, r, 4):
        tail = "," if i + 4 < r else ""
        lines.append("          " + ", ".join(out_rows[i:i + 4]) + tail)
    lines.append('        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), '
                 '"l"(desc_b), "r"(scale_d));')
    lines.append("  }")
    lines.append("};")
    return "\n".join(lines) + "\n"


def main():
    text = HEAD + "".join(wrapper(n) for n in WIDTHS) + TAIL
    out = Path(__file__).resolve().parent / "wgmma_tf32.cuh"
    out.write_text(text)


if __name__ == "__main__":
    main()
