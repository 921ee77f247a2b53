// The weight-only quantized matmul on the tensor cores for bf16 x, with
// wgmma: K6 (int8 weights, quant_matmul.cu's lct_quant_matmul_wg) and K10
// (packed int4 weights, quant4_matmul.cu's lct_quant4_matmul_wg) are the
// two instances of one kernel, templated on the weight format.
//
// Both compute what the Pallas kernels compute: x [M, K] bf16 times the
// weights converted exactly to bf16, float32 sums, times the column's
// float32 scale after the sum, cast to the output type (bf16 or float32).
// int8: w [K, N], one value a byte. int4: w [K/2, N], byte (r, n) holding
// logical row r in its low nibble and row r + K/2 in its high nibble, both
// sign-extended.
//
// What bounds it on the card: bytes, at decode's M <= 64 (at most 128
// operations an int8 weight byte, 256 an int4 one, both below the ~295 of
// the bf16 ridge); it nears the tensor cores' rate at M = 128-256. So the
// design keeps the weight bytes moving at the card's rate and everything
// else off device memory.
//
// Design. The product is taken transposed, out^T = w^T x^T: the weights
// are wgmma's A operand (64 columns of w a warpgroup a product), from
// registers, and x^T is its B operand, from shared memory, with x's M rows
// padded to MP (the next of 8, 16, 32, 64, 96, 128, 192, 256) as wgmma's
// N. So the weight bytes go from the staged bytes straight into A
// fragments and never through shared memory as bf16, and one code serves
// M = 1 (MP = 8) to M = 256.
//
// - One block per (tile of kBN = 128 columns, part of K); the parts of one
//   column tile form a thread-block cluster of `splits` <= 8 blocks. Block:
//   two consumer warpgroups (each owns 64 of the columns) and one producer
//   warp. (256-column tiles timed no faster on the H100 at any shape tried,
//   and their doubled A fragments made ptxas serialise the products.)
// - The producer streams the block's K part through a ring of `stages`
//   stages of 128 logical rows of K. A stage is 2D TMA boxes
//   (cp.async.bulk.tensor with a tensor map for w and one for x, 128-byte
//   swizzle), each w box 64 rows x 128 columns of bytes and each x box MP
//   rows x 64 columns: int4, one w box of packed rows [r0, r0 + 64) and the
//   two x boxes its bytes meet, x's columns [r0, r0 + 64) (the low
//   nibbles' rows) and [K/2 + r0, K/2 + r0 + 64) (the high nibbles'); int8,
//   two w boxes of rows [r0, r0 + 128) and x's columns [r0, r0 + 128). TMA
//   zero-fills x's rows past M, which are never stored. One mbarrier a
//   stage counts the boxes' bytes; one more counts the consumer warps that
//   are done with it. The tensor maps are encoded on the host for each call
//   (cuTensorMapEncodeTiled, reached through the runtime's driver entry
//   point, so nothing links against libcuda). x is read from L2 once per
//   block: its traffic is MP / 64 times the int8 weight bytes (MP / 32 times
//   the int4 ones).
// - Unpack with bit operations: ldmatrix.trans (its row addresses following
//   the swizzle) hands a lane the bytes of rows (2t, 2t + 1) at columns
//   (2g, 2g + 1). int4: (bytes & 0x000F000F) ^ 0x43084308 is the bf16 pair
//   128 + (nibble ^ 8), and one __hsub2 of 136 gives the sign-extended
//   nibbles exactly, two values a lop3 and a subtract; each byte feeds two
//   products, its low nibble against the low x box, its high nibble against
//   the high one. int8: bytes_bf16 below, two permutes and an add a value;
//   each byte is one value of one product. Either way no integer-to-float
//   conversions. The fragment's rows g and g + 8 are w's columns 2g and
//   2g + 1, a permutation undone at the store.
// - wgmma.mma_async m64nMPk16 (bf16 in, float32 accumulators in registers;
//   B by a 128-byte-swizzle K-major descriptor), eight a stage, committed
//   and waited a stage at a time. (For int8, committing each box's four
//   and unpacking the next box while they ran timed no faster on the
//   H100.)
// - Split-K reduced inside the launch: each block writes its float32
//   partial tile to its own shared memory; after a cluster barrier, rank r
//   adds its 1 / splits share of the tile over ranks 0, 1, ... in that
//   order through distributed shared memory, then scales, casts and stores.
//   No workspace, no second launch, the same bits from run to run. With one
//   part the block scales, casts and stores from its registers.
//
// What still bounds it: at M <= 16 the first stage's round trip and the
// cluster's reduction in a kernel of a few microseconds; at M >= 64 the
// padded M, one 64-row wgmma a warpgroup a k-step, and x's re-reads from L2
// (the MP = 256 instantiations spill).
#pragma once

#include <cooperative_groups.h>
#include <cuda.h>

#include "common.cuh"

namespace {
namespace wgmma {

namespace cg = cooperative_groups;

constexpr int kConsumers = 2;                      // consumer warpgroups, 64 columns each
constexpr int kThreads = kConsumers * 128 + 32;    // and one producer warp
constexpr int kBN = 128;                           // columns a block
constexpr int kRows = 64;                          // rows of a w box
constexpr int kBox = 128;                          // bytes a swizzled box row holds
constexpr int kWBox = kRows * kBox;                // a 64-row x 128-column box of w
constexpr int kPartPad = 8;                        // floats a partial-tile row is padded by
constexpr int kMaxStages = 8;
constexpr int kMaxSplits = 8;                      // blocks a cluster

// A stage: its w boxes (1 for int4, 2 for int8), then x's two boxes (each
// MP rows of 128 bytes). Every box starts on 1024 bytes, as the swizzle
// needs.
__host__ __device__ constexpr int w_boxes(bool int4) { return int4 ? 1 : 2; }
__host__ __device__ constexpr int stage_bytes(bool int4, int mp) {
  return w_boxes(int4) * kWBox + 2 * mp * kBox;
}
__host__ __device__ constexpr int partial_bytes(int mp) { return mp * (kBN + kPartPad) * 4; }
// The ring (which the partial tile reuses at the end), then the barriers.
__host__ __device__ constexpr int ring_bytes(bool int4, int mp, int stages) {
  return stages * stage_bytes(int4, mp) > partial_bytes(mp) ? stages * stage_bytes(int4, mp)
                                                             : partial_bytes(mp);
}
int smem_bytes(bool int4, int mp, int stages) {
  return ring_bytes(int4, mp, stages) + 2 * kMaxStages * 8;
}

// D (64 x N, float32, in registers) += A (64 x 16 bf16, registers: the
// m16n8k16 A fragment of each warp's 16 rows) * B (16 x N bf16, shared
// memory, described by desc).
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                         uint64_t desc);

template <>
__device__ __forceinline__ void wgmma_rs<8>(float (&d)[4], const uint32_t (&a)[4],
                                            uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3"
      "}, {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<16>(float (&d)[8], const uint32_t (&a)[4],
                                            uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16], const uint32_t (&a)[4],
                                            uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32], const uint32_t (&a)[4],
                                            uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<96>(float (&d)[48], const uint32_t (&a)[4],
                                            uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
      "}, {%48, %49, %50, %51}, %52, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64], const uint32_t (&a)[4],
                                            uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<192>(float (&d)[96], const uint32_t (&a)[4],
                                            uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, {%96, %97, %98, %99}, %100, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<256>(float (&d)[128], const uint32_t (&a)[4],
                                            uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keeps the compiler from moving accesses of an accumulator register
// across the asynchronous products.
__device__ __forceinline__ void fence_reg(float& r) { asm volatile("" : "+f"(r)::"memory"); }

// A shared-memory matrix descriptor for wgmma: K-major, 128-byte swizzle
// (rows of 128 bytes, 8-row groups 1024 bytes apart); a k16 step inside the
// 64-column box is +32 bytes on the start address.
__device__ __forceinline__ uint64_t smem_desc_sw128(unsigned addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

// A 2D box of `map` at (c0 innermost, c1) into shared memory by TMA,
// completion counted in bytes on `bar`.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n"
      :: "r"(lct_smem(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
         "r"(lct_smem(bar))
      : "memory");
}

// Two sign-extended nibbles, at bits 0-3 and 16-19 of v (the rest is
// ignored), as a bf16 pair: (n ^ 8) | 0x4300 is 128 + (n ^ 8) exactly, and
// 136 less that is the nibble's value.
__device__ __forceinline__ uint32_t nibbles_bf16(uint32_t v) {
  const uint32_t biased = (v & 0x000F000Fu) ^ 0x43084308u;
  const __nv_bfloat162 r = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&biased),
                                   __floats2bfloat162_rn(136.f, 136.f));
  return *reinterpret_cast<const uint32_t*>(&r);
}

// The four int8 values of a 32-bit word as two bf16 pairs, exactly: (byte 0,
// byte 2) into `even` and (byte 1, byte 3) into `odd`, low half first. Each
// byte, biased to unsigned, becomes the low mantissa byte of 2^23 and one
// add takes 2^23 + 128 off, which leaves the value as a float; an integer
// with |v| <= 128 has no bits in a float's low 16, so the top half of each
// float is its bf16, and one byte permute packs two of them. Two permutes
// and an add a value, no integer-to-float conversion.
__device__ __forceinline__ void bytes_bf16(uint32_t w, uint32_t& even, uint32_t& odd) {
  const uint32_t u = w ^ 0x80808080u;
  const float f0 = __int_as_float(__byte_perm(u, 0x4B000000u, 0x7540)) - 8388736.f;
  const float f1 = __int_as_float(__byte_perm(u, 0x4B000000u, 0x7541)) - 8388736.f;
  const float f2 = __int_as_float(__byte_perm(u, 0x4B000000u, 0x7542)) - 8388736.f;
  const float f3 = __int_as_float(__byte_perm(u, 0x4B000000u, 0x7543)) - 8388736.f;
  even = __byte_perm(__float_as_uint(f0), __float_as_uint(f2), 0x7632);
  odd = __byte_perm(__float_as_uint(f1), __float_as_uint(f3), 0x7632);
}

// Grid (splits, column tiles), clusters of (splits, 1, 1); block rank r
// covers rows [r * R / splits, (r + 1) * R / splits) of w (R = K/2 packed
// rows for int4, K for int8). wmap: w as [R rows, N bytes], boxes of 64 x
// 128; xmap: x as [M rows, K bf16], boxes of MP x 64.
template <bool kInt4, typename TO, int MP>
__global__ void __launch_bounds__(kThreads, MP <= 64 ? 2 : 1)
    quant_wgmma_kernel(const __grid_constant__ CUtensorMap wmap,
                       const __grid_constant__ CUtensorMap xmap,
                       const float* __restrict__ scale, TO* __restrict__ out, int m, int k,
                       int n, int stages) {
  constexpr int kWBoxes = w_boxes(kInt4);
  constexpr int kStageRows = kWBoxes * kRows;  // rows of w a stage
  constexpr int kAcc = MP / 2;                 // accumulators a thread holds
  constexpr int kStage = stage_bytes(kInt4, MP);
  constexpr int kXBox = MP * kBox;
  constexpr int kPartRow = kBN + kPartPad;
  extern __shared__ __align__(1024) unsigned char smem[];
  unsigned char* ring = smem;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + ring_bytes(kInt4, MP, stages));
  uint64_t* empty = full + kMaxStages;

  cg::cluster_group cluster = cg::this_cluster();
  const int splits = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int k2 = k / 2, rows = (kInt4 ? k2 : k) / splits, r_lo = rank * rows;
  const int n_stages = rows / kStageRows;
  const int n0 = blockIdx.y * kBN;
  const int t = threadIdx.x, warp = t / 32, lane = t % 32;

  if (t == 0) {
    for (int s = 0; s < stages; ++s) {
      lct_mbar_init(&full[s], 1);                // the producer's expect_tx
      lct_mbar_init(&empty[s], kConsumers * 4);  // each consumer warp
    }
    lct_mbar_init_fence();
  }
  __syncthreads();

  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;

  if (warp == kConsumers * 4) {
    // The producer (one lane): stage i of this block's part into ring slot
    // i % stages.
    if (lane == 0) {
      for (int i = 0; i < n_stages; ++i) {
        const int s = i % stages;
        lct_mbar_wait(&empty[s], ((i / stages) & 1) ^ 1);  // a fresh slot passes at once
        unsigned char* st = ring + s * kStage;
        const int r0 = r_lo + i * kStageRows;
        lct_mbar_arrive_expect_tx(&full[s], kStage);
#pragma unroll
        for (int j = 0; j < kWBoxes; ++j) {
          tma_load_2d(st + j * kWBox, &wmap, n0, r0 + j * kRows, &full[s]);
        }
        unsigned char* xs = st + kWBoxes * kWBox;
        tma_load_2d(xs, &xmap, r0, 0, &full[s]);
        tma_load_2d(xs + kXBox, &xmap, kInt4 ? k2 + r0 : r0 + kRows, 0, &full[s]);
      }
    }
  } else {
    // A consumer warpgroup: columns [64 wg, 64 wg + 64) of the tile; warp
    // wl of it holds [64 wg + 16 wl, + 16): one 16-byte chunk of each
    // swizzled w box row.
    const int wg = warp / 4, wl = warp % 4, chunk = wg * 4 + wl;
    for (int i = 0; i < n_stages; ++i) {
      const int s = i % stages;
      lct_mbar_wait(&full[s], (i / stages) & 1);
      const unsigned char* st = ring + s * kStage;
      // The A fragments of the stage's eight k16 products.
      uint32_t a[8][4];
      if constexpr (kInt4) {
        // a[2j], a[2j + 1]: the low, then high, nibbles of packed rows
        // [16j, 16j + 16) of the stage.
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = 32 * half + lane;
          uint32_t r[4];  // rows 8q + 2t, 8q + 2t + 1 of the half, columns 2g, 2g + 1
          lct_ldmatrix_x4_trans(r, st + row * kBox + ((chunk ^ (row & 7)) << 4));
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const uint32_t r0 = r[2 * q], r1 = r[2 * q + 1];
            uint32_t(&lo)[4] = a[2 * (2 * half + q)];
            uint32_t(&hi)[4] = a[2 * (2 * half + q) + 1];
            lo[0] = nibbles_bf16(r0);       // column 2g, k 2t, 2t + 1
            lo[1] = nibbles_bf16(r0 >> 8);  // column 2g + 1
            lo[2] = nibbles_bf16(r1);       // column 2g, k 2t + 8, 2t + 9
            lo[3] = nibbles_bf16(r1 >> 8);
            hi[0] = nibbles_bf16(r0 >> 4);
            hi[1] = nibbles_bf16(r0 >> 12);
            hi[2] = nibbles_bf16(r1 >> 4);
            hi[3] = nibbles_bf16(r1 >> 12);
          }
        }
      } else {
        // a[4 box + j]: rows [16j, 16j + 16) of w box `box`.
#pragma unroll
        for (int box = 0; box < 2; ++box) {
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int row = 32 * half + lane;
            uint32_t r[4];
            lct_ldmatrix_x4_trans(r, st + box * kWBox + row * kBox + ((chunk ^ (row & 7)) << 4));
#pragma unroll
            for (int q = 0; q < 2; ++q) {
              uint32_t(&f)[4] = a[4 * box + 2 * half + q];
              bytes_bf16(r[2 * q], f[0], f[1]);      // k 2t, 2t + 1: columns 2g, 2g + 1
              bytes_bf16(r[2 * q + 1], f[2], f[3]);  // k 2t + 8, 2t + 9
            }
          }
        }
      }
      // The descriptors are made before the products: an operand defined
      // between them would serialise them.
      const unsigned xs = lct_smem(st + kWBoxes * kWBox);
      uint64_t desc[8];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if constexpr (kInt4) {  // low box, high box, in turns
          desc[2 * j] = smem_desc_sw128(xs + 32 * j);
          desc[2 * j + 1] = smem_desc_sw128(xs + kXBox + 32 * j);
        } else {  // the first box's four k16 steps, then the second's
          desc[j] = smem_desc_sw128(xs + 32 * j);
          desc[4 + j] = smem_desc_sw128(xs + kXBox + 32 * j);
        }
      }
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < 8; ++j) wgmma_rs<MP>(acc, a[j], desc[j]);
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int i2 = 0; i2 < kAcc; ++i2) fence_reg(acc[i2]);
      __syncwarp();
      if (lane == 0) lct_mbar_arrive(&empty[s]);
    }
  }
  if (splits == 1) {  // no other part to add: scale, cast and store from registers
    if (warp < kConsumers * 4) {
      const int wg = warp / 4, wl = warp % 4, g = lane / 4, tq = lane % 4;
      const int c = n0 + wg * 64 + wl * 16 + 2 * g;
      const float s0 = scale[c], s1 = scale[c + 1];
#pragma unroll
      for (int j = 0; j < MP / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int row = 8 * j + 2 * tq + e;
          if (row < m) {
            out[(size_t)row * n + c] = lct_from_float<TO>(acc[4 * j + e] * s0);
            out[(size_t)row * n + c + 1] = lct_from_float<TO>(acc[4 * j + 2 + e] * s1);
          }
        }
      }
    }
    return;
  }
  __syncthreads();  // every stage is consumed: the ring becomes the partial tile

  // The partial tile [MP rows of x][kBN columns], float32. Accumulator
  // 4j + e: token 8j + 2t + (e & 1), column 64 wg + 16 wl + 2g + (e >> 1).
  float* part = reinterpret_cast<float*>(ring);
  if (warp < kConsumers * 4) {
    const int wg = warp / 4, wl = warp % 4, g = lane / 4, tq = lane % 4;
    const int c = wg * 64 + wl * 16 + 2 * g;
#pragma unroll
    for (int j = 0; j < MP / 8; ++j) {
      const int row = 8 * j + 2 * tq;
      *reinterpret_cast<float2*>(&part[row * kPartRow + c]) = make_float2(acc[4 * j], acc[4 * j + 2]);
      *reinterpret_cast<float2*>(&part[(row + 1) * kPartRow + c]) =
          make_float2(acc[4 * j + 1], acc[4 * j + 3]);
    }
  }
  cluster.sync();  // every rank's partial is written

  // Rank `rank` sums its share of the tile's 4-column groups over ranks 0,
  // 1, ... in that order, then scales, casts and stores.
  const int groups = m * (kBN / 4);
  const int share = (groups + splits - 1) / splits;
  const int g_hi = min(groups, (rank + 1) * share);
  for (int gi = rank * share + t; gi < g_hi; gi += kThreads) {
    const int row = gi / (kBN / 4), c = (gi % (kBN / 4)) * 4;
    float4 v[kMaxSplits];  // every rank's load in flight at once
#pragma unroll
    for (int q = 0; q < kMaxSplits; ++q) {
      if (q < splits) {
        v[q] = *reinterpret_cast<const float4*>(cluster.map_shared_rank(part, q) +
                                                row * kPartRow + c);
      }
    }
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int q = 0; q < kMaxSplits; ++q) {
      if (q < splits) {
        sum.x += v[q].x;
        sum.y += v[q].y;
        sum.z += v[q].z;
        sum.w += v[q].w;
      }
    }
    const float* sc = scale + n0 + c;
    TO* o = out + (size_t)row * n + n0 + c;
    o[0] = lct_from_float<TO>(sum.x * sc[0]);
    o[1] = lct_from_float<TO>(sum.y * sc[1]);
    o[2] = lct_from_float<TO>(sum.z * sc[2]);
    o[3] = lct_from_float<TO>(sum.w * sc[3]);
  }
  cluster.sync();  // no block leaves while another still reads its partial
}

// cuTensorMapEncodeTiled, through the runtime's driver entry point.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t rc = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                            cudaEnableDefault, &found);
#else
    const cudaError_t rc =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (rc == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 2D row-major tensor [outer, inner] of `type`, boxes of box_outer x
// box_inner elements (box_inner of them 128 bytes), 128-byte swizzle,
// out-of-bounds reads zero-filled.
int tensor_map(CUtensorMap* map, CUtensorMapDataType type, const void* base, uint64_t inner,
               uint64_t outer, uint64_t row_bytes, uint32_t box_inner, uint32_t box_outer) {
  const EncodeTiled fn = encode_tiled();
  if (!fn) return (int)cudaErrorSymbolNotFound;
  const cuuint64_t dims[2] = {inner, outer};
  const cuuint64_t strides[1] = {row_bytes};
  const cuuint32_t box[2] = {box_inner, box_outer};
  const cuuint32_t elem_strides[2] = {1, 1};
  const CUresult rc = fn(map, type, 2, const_cast<void*>(base), dims, strides, box, elem_strides,
                         CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <bool kInt4, typename TO, int MP>
int launch(const void* x, const void* w, const void* scale, void* out, int m, int k, int n,
           int splits, int stages, cudaStream_t st) {
  const auto kernel = quant_wgmma_kernel<kInt4, TO, MP>;
  const int smem = smem_bytes(kInt4, MP, stages);
  static int smem_set = 0;  // the opt-in above 48 KB, raised as needed
  if (smem > smem_set) {
    const cudaError_t rc =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (rc != cudaSuccess) return (int)rc;
    smem_set = smem;
  }
  CUtensorMap wmap, xmap;
  int rc = tensor_map(&wmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, w, n, kInt4 ? k / 2 : k, n, kBox,
                      kRows);
  if (!rc) {
    rc = tensor_map(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, k, m, (uint64_t)k * 2, kBox / 2, MP);
  }
  if (rc) return rc;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, n / kBN, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, kernel, wmap, xmap, static_cast<const float*>(scale),
                                 static_cast<TO*>(out), m, k, n, stages);
}

template <bool kInt4, typename TO>
int dispatch(const void* x, const void* w, const void* scale, void* out, int m, int k, int n,
             int mp, int splits, int stages, cudaStream_t st) {
  switch (mp) {
    case 8: return launch<kInt4, TO, 8>(x, w, scale, out, m, k, n, splits, stages, st);
    case 16: return launch<kInt4, TO, 16>(x, w, scale, out, m, k, n, splits, stages, st);
    case 32: return launch<kInt4, TO, 32>(x, w, scale, out, m, k, n, splits, stages, st);
    case 64: return launch<kInt4, TO, 64>(x, w, scale, out, m, k, n, splits, stages, st);
    case 96: return launch<kInt4, TO, 96>(x, w, scale, out, m, k, n, splits, stages, st);
    case 128: return launch<kInt4, TO, 128>(x, w, scale, out, m, k, n, splits, stages, st);
    case 192: return launch<kInt4, TO, 192>(x, w, scale, out, m, k, n, splits, stages, st);
    case 256: return launch<kInt4, TO, 256>(x, w, scale, out, m, k, n, splits, stages, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The launch, checked: mp in {8, 16, 32, 64, 96, 128, 192, 256} with M <=
// mp; N a multiple of 128; splits in {1, 2, 4, 8} with w's rows (K/2 for
// int4, K for int8) a multiple of 64 (int4) or 128 (int8) rows times
// splits; 2 <= stages <= 8; then cudaGetLastError().
template <bool kInt4>
int run(const void* x, const void* w, const void* scale, void* out, int m, int k, int n,
        int out_dtype, int mp, int splits, int stages, void* stream) {
  if (m <= 0 || n <= 0) return 0;
  const int rows = kInt4 ? k / 2 : k;
  if ((splits != 1 && splits != 2 && splits != 4 && splits != 8) || m > mp || n % kBN ||
      k <= 0 || (kInt4 && k % 2) || rows % (w_boxes(kInt4) * kRows * splits) || stages < 2 ||
      stages > kMaxStages) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc;
  if (out_dtype == LCT_DTYPE_F32) {
    rc = dispatch<kInt4, float>(x, w, scale, out, m, k, n, mp, splits, stages, st);
  } else if (out_dtype == LCT_DTYPE_BF16) {
    rc = dispatch<kInt4, __nv_bfloat16>(x, w, scale, out, m, k, n, mp, splits, stages, st);
  } else {
    rc = (int)cudaErrorInvalidValue;
  }
  if (rc) return rc;
  return (int)cudaGetLastError();
}

}  // namespace wgmma
}  // namespace
