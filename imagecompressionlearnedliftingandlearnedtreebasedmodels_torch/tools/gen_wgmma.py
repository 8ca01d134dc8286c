"""Write ``csrc/wgmma_bf16.cuh``: one inline-PTX ``wgmma`` per N tile.

    python -m imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.tools.gen_wgmma

``wgmma.mma_async`` names every accumulator register of the instruction in
its operand list (N/2 fp32 registers a thread for m64nNk16), and inline PTX
takes only string literals, so each N the conv kernel uses gets its own
function, written out here. ``tests/test_torch_conv_v2.py`` checks that the
committed header is what this script writes for ``ops/conv_v2.N_TILES``.
"""

from __future__ import annotations

import argparse
import os

from ..ops import conv_v2, nvcc

HEADER = os.path.join(nvcc.CSRC, "wgmma_bf16.cuh")


def _one(n: int) -> str:
    regs = n // 2
    lst = ", ".join(f"%{i}" for i in range(regs))
    outs = ",\n        ".join(
        ", ".join(f'"+f"(d[{i}])' for i in range(j, min(j + 4, regs)))
        for j in range(0, regs, 4))
    return f"""
// m64n{n}k16: A K-major, B N-major in shared memory; fp32 sums += A * B
template <>
__device__ __forceinline__ void wgmma_bf16<{n}>(float (&d)[{regs}],
                                               uint64_t a, uint64_t b) {{
  asm volatile(
      "{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{regs + 2}, 0;\\n"
      "wgmma.mma_async.sync.aligned.m64n{n}k16.f32.bf16.bf16 "
      "{{{lst}}}, %{regs}, %{regs + 1}, p, 1, 1, 0, 1;\\n}}\\n"
      : {outs}
      : "l"(a), "l"(b), "r"(1));
}}
"""


def render(n_tiles=conv_v2.N_TILES) -> str:
    body = "".join(_one(n) for n in n_tiles)
    return f"""// Written by tools/gen_wgmma.py; do not edit by hand.
//
// wgmma.mma_async m64nNk16 bf16 x bf16 -> fp32, scale-d true (D += A * B),
// A and B from shared-memory matrix descriptors, A K-major, B transposed
// (N-major: imm-trans-b 1). One function per N tile of csrc/conv_v2.cu.
#pragma once
#include <cstdint>

template <int N>
__device__ __forceinline__ void wgmma_bf16(float (&d)[N / 2], uint64_t a,
                                           uint64_t b);
{body}"""


def main() -> None:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args()
    with open(HEADER, "w") as fh:
        fh.write(render())
    print(HEADER)


if __name__ == "__main__":
    main()
