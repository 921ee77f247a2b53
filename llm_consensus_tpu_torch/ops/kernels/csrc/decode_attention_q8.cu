// K4 (and K5, which is K4 on one layer's view of the stacked cache):
// one-token decode attention over the int8 head-major cache, as a split-KV
// pass.
//
// Replaces the Pallas kernel llm_consensus_tpu/ops/pallas/attention.py
// flash_decode_attention_q8 (-> _decode_q8_row_kernel and _decode_q8_kernel,
// whose arithmetic is _q8_attend). Same semantics: q [B, 1, H, D] (float32
// or bf16), the cache [B, Hkv, S_max, D] int8 with a float32 scale per slot
// [B, Hkv, S_max]; query head h reads kv head h / G; scores are
// q . k_q times k_scale * d^-1/2; slots >= valid_len[b] are masked; the
// softmax runs in float32, the V scale folds into the value product only
// (p * v_scale), the denominator stays the true sum of p; output in q's type.
// A row with valid_len 0 gives zeros.
//
// What bounds it on the card: bytes. A slot costs D + 4 bytes of K and as
// many of V per kv head, for ~4 * G operations a byte: far below the ridge,
// so tensor cores would buy nothing. What matters is having enough bytes in
// flight on every SM (Little's law: ~20 KB an SM to keep 3.35 TB/s moving)
// and enough blocks to reach every SM at decode's small batches.
//
// Design. Grid (Hkv, B, n_split): a block takes one contiguous span of
// slots of one (row, kv head) and serves all G query heads of the kv head
// from one read. n_split and the span (a whole number of 32-slot chunks, at
// least 128 slots) come from the host-known shapes only
// (ops/kernels/attention.py: decode_q8_splits), never from valid_len, which
// lives on the card: a block whose span starts past its row's valid_len
// writes an empty partial (max -inf, sum 0) and exits.
//
// A block is 4 warps, each an independent pipeline: warp w takes chunks w,
// w + 4, ... of the span through its own ring of kWStages stages (K rows, V
// rows and both scales of 32 slots), filled by its own lanes with 16-byte
// cp.async (4-byte for the scales) and tracked by one mbarrier a stage
// that each lane's copies arrive on; the next chunk is in flight while one
// is scored, ~70 KB a block in flight at D = 128, three blocks an SM
// (dynamic shared memory above 48 KB, opted into). Every warp works
// whatever G is. A chunk is scored as K7's prefix pass does it: lane s
// scores slot s for every head (K rows padded by 16 bytes so the 32 lanes'
// 16-byte reads hit distinct banks; int8 to float by a byte permute and an
// add, not a conversion instruction), one max reduction and one exp a
// lane a chunk, then P * V from shared memory with lane i holding
// dimensions D/32 * i onwards and p times the V scale read back four slots
// at a time. The warps' states merge by log-sum-exp through shared memory.
// With n_split > 1 each block writes its (max, sum, unnormalised output) to
// a float32 workspace and a second small launch merges the splits in split
// order, so a result does not change from run to run; it is launched as a
// programmatic dependent (its blocks wait on the split pass with
// griddepcontrol.wait), which hides its launch. With one split the block
// writes the output itself.

#include "common.cuh"

namespace {

constexpr int kThreads = 128;             // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 32;                // slots a stage: one lane a slot
constexpr int kWStages = 2;               // stages a warp: one in flight while one is scored

template <int D>
struct __align__(16) Stage {
  int8_t k[kChunk][D + 16];  // padded by one 16-byte vector (banks)
  int8_t v[kChunk][D];
  float ks[kChunk];
  float vs[kChunk];
};

// Dynamic shared memory of a block: each warp's ring, then q, then each
// warp's probabilities (times the V scale) for the chunk it scores.
template <int D, int G>
constexpr int smem_bytes() {
  return kWarps * kWStages * (int)sizeof(Stage<D>) + G * D * 4 + kWarps * G * kChunk * 4 +
         kWarps * kWStages * 8;
}

struct SplitArgs {
  const void* q;
  const int8_t* kq;
  const float* ks;
  const int8_t* vq;
  const float* vs;
  const int* valid_len;
  void* out;
  // n_split > 1: [n_split, B * H] max and sum, [n_split, B * H, D] output.
  float* pm;
  float* pl;
  float* pacc;
  int b, s_max, hkv, span, n_split;
  float scale;
};

// Four int8 values (one 32-bit word) as floats, exactly: each byte, biased
// to unsigned, becomes the low mantissa byte of 2^23, and one add takes
// 2^23 + 128 off. A byte permute and an add a value, where a conversion
// instruction runs at a quarter of the add's rate.
__device__ __forceinline__ void i8x4_to_float(uint32_t w, float* f) {
  const uint32_t u = w ^ 0x80808080u;
  f[0] = __int_as_float(__byte_perm(u, 0x4B000000u, 0x7540)) - 8388736.f;
  f[1] = __int_as_float(__byte_perm(u, 0x4B000000u, 0x7541)) - 8388736.f;
  f[2] = __int_as_float(__byte_perm(u, 0x4B000000u, 0x7542)) - 8388736.f;
  f[3] = __int_as_float(__byte_perm(u, 0x4B000000u, 0x7543)) - 8388736.f;
}

// The kDPL dimensions from lane * kDPL of an int8 row, as floats.
template <int D>
__device__ __forceinline__ void load_row_share(const int8_t* row, int lane, float* r) {
  constexpr int kDPL = (D + 31) / 32;
  const int d0 = lane * kDPL;
  if (d0 >= D) {  // D = 16: lanes 16..31 hold nothing
#pragma unroll
    for (int e = 0; e < kDPL; ++e) r[e] = 0.f;
    return;
  }
  if constexpr (kDPL == 4) {
    i8x4_to_float(*reinterpret_cast<const uint32_t*>(row + d0), r);
  } else if constexpr (kDPL == 2) {
    const char2 c = *reinterpret_cast<const char2*>(row + d0);
    r[0] = c.x;
    r[1] = c.y;
  } else {
    r[0] = row[d0];
  }
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off /= 2) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

template <typename T, int D, int G>
__global__ void __launch_bounds__(kThreads) decode_q8_split_kernel(SplitArgs a) {
  constexpr int kDPL = (D + 31) / 32;  // V dimensions a lane holds
  constexpr int kVec = D / 16;         // 16-byte vectors in a row
  extern __shared__ __align__(16) unsigned char smem[];
  Stage<D>* ring = reinterpret_cast<Stage<D>*>(smem);  // [warp][stage]
  float(*sq)[D] = reinterpret_cast<float(*)[D]>(smem + kWarps * kWStages * sizeof(Stage<D>));
  float(*sp)[G][kChunk] = reinterpret_cast<float(*)[G][kChunk]>(&sq[G][0]);  // [warp]
  uint64_t* full = reinterpret_cast<uint64_t*>(&sp[kWarps][0][0]);           // [warp][stage]

  const int kvh = blockIdx.x, b = blockIdx.y, split = blockIdx.z;
  const int h = a.hkv * G;
  const size_t head0 = (size_t)b * h + kvh * G;  // first query head
  const size_t bh = (size_t)a.b * h;
  const int t = threadIdx.x, lane = t % 32, warp = t / 32;
  const T* q = static_cast<const T*>(a.q);
  T* out = static_cast<T*>(a.out);
  // q is read before valid_len is known, so the two loads overlap.
  float qv[(G * D + kThreads - 1) / kThreads];
#pragma unroll
  for (int r = 0; r < (G * D + kThreads - 1) / kThreads; ++r) {
    const int i = t + r * kThreads;
    qv[r] = i < G * D ? lct_to_float(q[head0 * D + i]) * a.scale : 0.f;
  }
  const int n = min(max(a.valid_len[b], 0), a.s_max);
  const int lo = split * a.span, hi = min(n, lo + a.span);

  if (lo >= hi) {  // nothing to read (block-uniform): an empty partial
    if (a.n_split > 1) {
      for (int g = t; g < G; g += kThreads) {
        a.pm[split * bh + head0 + g] = -INFINITY;
        a.pl[split * bh + head0 + g] = 0.f;
      }
    } else {
      for (int i = t; i < G * D; i += kThreads) out[head0 * D + i] = lct_from_float<T>(0.f);
    }
    return;
  }

#pragma unroll
  for (int r = 0; r < (G * D + kThreads - 1) / kThreads; ++r) {
    const int i = t + r * kThreads;
    if (i < G * D) sq[i / D][i % D] = qv[r];
  }
  if (lane < kWStages) lct_mbar_init(&full[warp * kWStages + lane], 32);
  lct_mbar_init_fence();
  __syncthreads();

  // Warp w takes chunks w, w + 4, ... of the block's span, through its own
  // ring: its lanes fill its stages and it alone reads them.
  const size_t row0 = ((size_t)b * a.hkv + kvh) * a.s_max;  // slot 0's cache row
  const int n_chunks = (hi - lo + kChunk - 1) / kChunk;
  const int my_chunks = n_chunks > warp ? (n_chunks - warp + kWarps - 1) / kWarps : 0;
  Stage<D>* my_ring = ring + warp * kWStages;
  uint64_t* my_full = full + warp * kWStages;
  // The warp's i-th chunk into its stage i % kWStages; each lane arrives
  // once a fill, when its copies have landed; slots past hi are zero-filled.
  auto fill = [&](int i) {
    Stage<D>& st = my_ring[i % kWStages];
    const int c0 = lo + (warp + i * kWarps) * kChunk, nc = min(kChunk, hi - c0);
#pragma unroll
    for (int j = lane; j < kChunk * kVec; j += 32) {
      const int s = j / kVec, v = j % kVec;
      const size_t off = (row0 + c0 + min(s, nc - 1)) * D + v * 16;
      lct_cp_async16(&st.k[s][v * 16], a.kq + off, s < nc);
      lct_cp_async16(&st.v[s][v * 16], a.vq + off, s < nc);
    }
    const size_t so = row0 + c0 + min(lane, nc - 1);
    lct_cp_async4(&st.ks[lane], a.ks + so, lane < nc);
    lct_cp_async4(&st.vs[lane], a.vs + so, lane < nc);
    lct_cp_async_mbar_arrive(&my_full[i % kWStages]);
  };

  // Per head: running max (warp-uniform), this lane's share of the running
  // sum, and the output dimensions this lane holds.
  float m[G], l[G], acc[G][kDPL];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < kDPL; ++e) acc[g][e] = 0.f;
  }

  if (my_chunks > 0) fill(0);
  for (int i = 0; i < my_chunks; ++i) {
    __syncwarp();  // every lane is done with the stage the next fill takes
    if (i + 1 < my_chunks) fill(i + 1);
    lct_mbar_wait(&my_full[i % kWStages], (i / kWStages) & 1);
    const Stage<D>& st = my_ring[i % kWStages];
    const int nc = min(kChunk, hi - (lo + (warp + i * kWarps) * kChunk));

    // Lane s scores slot s for every head, in four partial sums a head (so
    // the adds do not form one chain of D dependent instructions).
    float sc[G][4];
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int u = 0; u < 4; ++u) sc[g][u] = 0.f;
#pragma unroll
    for (int v = 0; v < kVec; ++v) {
      const uint4 kw = *reinterpret_cast<const uint4*>(&st.k[lane][v * 16]);
      float kf[16];
      i8x4_to_float(kw.x, kf);
      i8x4_to_float(kw.y, kf + 4);
      i8x4_to_float(kw.z, kf + 8);
      i8x4_to_float(kw.w, kf + 12);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float4* qq = reinterpret_cast<const float4*>(&sq[g][v * 16]);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float4 q4 = qq[u];
          sc[g][u] += q4.x * kf[4 * u] + q4.y * kf[4 * u + 1] + q4.z * kf[4 * u + 2] +
                      q4.w * kf[4 * u + 3];
        }
      }
    }
    const float ksc = st.ks[lane], vsc = st.vs[lane];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float dot = (sc[g][0] + sc[g][1]) + (sc[g][2] + sc[g][3]);
      const float s_lane = lane < nc ? dot * ksc : -INFINITY;
      const float m_new = fmaxf(m[g], warp_max(s_lane));  // lane 0's slot is valid
      const float alpha = m[g] == -INFINITY ? 0.f : expf(m[g] - m_new);
      const float p = lane < nc ? expf(s_lane - m_new) : 0.f;
      l[g] = l[g] * alpha + p;
      sp[warp][g][lane] = p * vsc;  // the V scale folds into the value product only
#pragma unroll
      for (int e = 0; e < kDPL; ++e) acc[g][e] *= alpha;
      m[g] = m_new;
    }
    __syncwarp();
    for (int s0 = 0; s0 < nc; s0 += 4) {
      float vr[4][kDPL];
#pragma unroll
      for (int u = 0; u < 4; ++u) load_row_share<D>(st.v[s0 + u], lane, vr[u]);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float4 p4 = *reinterpret_cast<const float4*>(&sp[warp][g][s0]);
#pragma unroll
        for (int e = 0; e < kDPL; ++e) {
          acc[g][e] += p4.x * vr[0][e] + p4.y * vr[1][e] + p4.z * vr[2][e] + p4.w * vr[3][e];
        }
      }
    }
  }
  // The merge launch (if any) may start arriving; it waits for this grid.
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");

  // The 4 warps' states merged by log-sum-exp through shared memory (the
  // rings are no longer read).
  __syncthreads();
  float* wm = reinterpret_cast<float*>(smem);  // [warp][G]
  float* wl = wm + kWarps * G;                 // [warp][G]
  float* wacc = wl + kWarps * G;               // [warp][G][D]
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const float l_tot = lct_group_sum<32>(l[g]);
    if (lane == 0) {
      wm[warp * G + g] = m[g];
      wl[warp * G + g] = l_tot;
    }
#pragma unroll
    for (int e = 0; e < kDPL; ++e) {
      const int d = lane * kDPL + e;
      if (d < D) wacc[(warp * G + g) * D + d] = acc[g][e];
    }
  }
  __syncthreads();
  for (int i = t; i < G * D; i += kThreads) {
    const int g = i / D, d = i % D;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, wm[w * G + g]);
    float tot_l = 0.f, tot = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      if (wm[w * G + g] == -INFINITY) continue;  // a warp that had no chunk
      const float c = expf(wm[w * G + g] - mx);
      tot_l += wl[w * G + g] * c;
      tot += wacc[(w * G + g) * D + d] * c;
    }
    const size_t head = head0 + g;
    if (a.n_split == 1) {
      out[head * D + d] = lct_from_float<T>(tot_l > 0.f ? tot / tot_l : 0.f);
    } else {
      if (d == 0) {
        a.pm[split * bh + head] = mx;
        a.pl[split * bh + head] = tot_l;
      }
      a.pacc[(split * bh + head) * D + d] = tot;
    }
  }
}

// The splits of each (row, head) merged by log-sum-exp, in split order. One
// block of D threads per query head; empty splits (max -inf) are skipped.
// Launched as a programmatic dependent of the split pass: its blocks may
// be resident early and wait here for that grid to finish and flush.
template <typename T, int D>
__global__ void __launch_bounds__(D) decode_q8_merge_kernel(SplitArgs a, int h) {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const size_t head = blockIdx.x, bh = (size_t)a.b * h;
  const int d = threadIdx.x;
  float mx = -INFINITY;
#pragma unroll 8
  for (int sp = 0; sp < a.n_split; ++sp) mx = fmaxf(mx, a.pm[sp * bh + head]);
  float tot_l = 0.f, tot = 0.f;
  if (mx != -INFINITY) {
#pragma unroll 8
    for (int sp = 0; sp < a.n_split; ++sp) {
      const float pm = a.pm[sp * bh + head];
      const float c = pm == -INFINITY ? 0.f : expf(pm - mx);
      tot_l += a.pl[sp * bh + head] * c;
      tot += (pm == -INFINITY ? 0.f : a.pacc[(sp * bh + head) * D + d]) * c;
    }
  }
  static_cast<T*>(a.out)[head * D + d] = lct_from_float<T>(tot_l > 0.f ? tot / tot_l : 0.f);
}

template <typename T, int D, int G>
int launch_g(const SplitArgs& a, cudaStream_t st) {
  const auto kernel = decode_q8_split_kernel<T, D, G>;
  constexpr int smem = smem_bytes<D, G>();
  static bool opted_in = false;  // dynamic shared memory above 48 KB
  if (!opted_in) {
    const cudaError_t rc =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (rc != cudaSuccess) return (int)rc;
    opted_in = true;
  }
  kernel<<<dim3(a.hkv, a.b, a.n_split), kThreads, smem, st>>>(a);
  return 0;
}

template <typename T, int D>
int launch_d(const SplitArgs& a, int g, cudaStream_t st) {
  int rc;
  switch (g) {
    case 1: rc = launch_g<T, D, 1>(a, st); break;
    case 2: rc = launch_g<T, D, 2>(a, st); break;
    case 4: rc = launch_g<T, D, 4>(a, st); break;
    case 8: rc = launch_g<T, D, 8>(a, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (rc || a.n_split == 1) return rc;
  const int h = a.hkv * g;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.b * h, 1, 1);
  cfg.blockDim = dim3(D, 1, 1);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, decode_q8_merge_kernel<T, D>, a, h);
}

template <typename T>
int dispatch_d(const SplitArgs& a, int g, int d, cudaStream_t st) {
  switch (d) {
    case 16: return launch_d<T, 16>(a, g, st);
    case 32: return launch_d<T, 32>(a, g, st);
    case 64: return launch_d<T, 64>(a, g, st);
    case 128: return launch_d<T, 128>(a, g, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// K4. q: [B, 1, H, D] float32 or bfloat16 (dtype); k_q, v_q: [B, Hkv, S_max,
// D] int8, 16-byte aligned; k_scale, v_scale: [B, Hkv, S_max] float32;
// valid_len: [B] int32; out: [B, 1, H, D] in q's type; all contiguous on the
// card. Block z of a (row, kv head) reads slots [z * span, (z + 1) * span):
// span a multiple of 32, n_split * span >= S_max > (n_split - 1) * span. ws:
// n_split > 1, a float32 workspace of n_split * B * H * (D + 2) elements;
// else unused.
extern "C" int lct_decode_attention_q8(const void* q, const void* k_q,
                                       const void* k_scale, const void* v_q,
                                       const void* v_scale,
                                       const void* valid_len, void* out,
                                       void* ws, int b, int s_max, int h,
                                       int hkv, int d, int n_split, int span,
                                       float scale, int dtype, void* stream) {
  if (b <= 0) return 0;
  if (hkv <= 0 || h % hkv || n_split < 1 || span <= 0 || span % kChunk ||
      (size_t)n_split * span < (size_t)s_max ||
      (size_t)(n_split - 1) * span >= (size_t)max(s_max, 1) || (n_split > 1 && !ws)) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t bh = (size_t)b * h;
  float* w = static_cast<float*>(ws);
  const SplitArgs a{q, static_cast<const int8_t*>(k_q), static_cast<const float*>(k_scale),
                    static_cast<const int8_t*>(v_q), static_cast<const float*>(v_scale),
                    static_cast<const int*>(valid_len), out,
                    w, w ? w + n_split * bh : nullptr, w ? w + 2 * n_split * bh : nullptr,
                    b, s_max, hkv, span, n_split, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc;
  if (dtype == LCT_DTYPE_F32) {
    rc = dispatch_d<float>(a, h / hkv, d, st);
  } else if (dtype == LCT_DTYPE_BF16) {
    rc = dispatch_d<__nv_bfloat16>(a, h / hkv, d, st);
  } else {
    rc = (int)cudaErrorInvalidValue;
  }
  if (rc) return rc;
  return (int)cudaGetLastError();
}
