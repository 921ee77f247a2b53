// K10 on the tensor cores: the W4A16 matmul for bf16 x, with wgmma.
//
// Replaces the Pallas kernel llm_consensus_tpu/ops/pallas/quant_matmul.py
// quant4_matmul_2d (-> _q4mm_kernel) for bf16 x, and computes what it
// computes: x [M, K] bf16 times the packed int4 w [K/2, N] (byte (r, n)
// holds logical row r in its low nibble and row r + K/2 in its high
// nibble, both sign-extended), float32 sums, times the column's float32
// scale after the sum, cast to the output type (bf16 or float32). The
// CUDA-core form for float32 x stays in quant_matmul.cu.
//
// The kernel is quant_wgmma.cuh's, on its int4 weight format (K6 runs the
// same kernel on int8 weights): what bounds it and what its design does
// about that are in that file's note. A stage is one 64 x 128 box of packed
// rows and the two x boxes its nibbles meet; each byte feeds two products.

#include "quant_wgmma.cuh"

// K10 for bf16 x: x [M, K] bf16, 16-byte aligned; w [K/2, N] packed int4,
// 16-byte aligned; scale [N] float32; out [M, N] float32 or bfloat16
// (out_dtype); all contiguous on the card. N a multiple of 128. The launch
// (ops/kernels/quant_matmul.py: wgmma_tile): mp in {8, 16, 32, 64, 96,
// 128, 192, 256} with M <= mp; splits in {1, 2, 4, 8} with K/2 a multiple of 64 *
// splits; 2 <= stages <= 8.
extern "C" int lct_quant4_matmul_wg(const void* x, const void* w, const void* scale,
                                    void* out, int m, int k, int n, int out_dtype, int mp,
                                    int splits, int stages, void* stream) {
  return wgmma::run<true>(x, w, scale, out, m, k, n, out_dtype, mp, splits, stages, stream);
}
