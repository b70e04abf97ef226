// Packed segment-causal flash attention, backward, for Hopper (sm_90a).
//
// Replaces the TPU library kernels behind the backward of
// areal_tpu/ops/pallas/flash_attention.py:200 `flash_attention` (the Pallas
// TPU flash-attention library file, experimental/pallas/ops/tpu/
// flash_attention.py, release 0.9.0):
//   K2 `_flash_attention_bwd_dkv` -> flash_bwd_dkv_kernel (dk, dv)
//   K3 `_flash_attention_bwd_dq`  -> flash_bwd_dq_kernel  (dq)
// under K1's mask (flash_attention.cu): a (row i, column j) pair is kept when
// both segment ids are equal and nonzero and, when causal, j <= i.
//
// Both recompute the probabilities from K1's logsumexp, P = exp(s*scale - lse),
// and take di = rowsum(dO * O) (f32, computed by the wrapper, as the library
// computes it outside its kernels):
//   dV = P^T dO,  dP = dO V^T,  dS = P * (dP - di),
//   dQ = scale * dS K,  dK = scale * dS^T Q.
// Rows whose lse is -inf (pad queries, rows without a valid key) keep no
// pair, so they give dq = 0 and add nothing to dk or dv; exp2f never sees
// -inf - -inf. Pad columns (segment 0) come out as exact zeros.
//
// Differences from the TPU kernels: GQA without repeating K/V (K2 sums the
// G = Hq / Hkv query heads of its kv head itself, K3 reads kv head h / G);
// head_dim 64 and 128 are template cases (no padding to 128 lanes); any T and
// S (ragged tails are masked); no block-size knobs; causal-future tiles are
// skipped in both kernels.
//
// Design. K3: one block per (64-row q tile, q head, batch row), 256 threads,
// four per query row, looping over the KV tiles up to the diagonal, as K1.
// K2: one block per (64-key kv tile, kv head, batch row), four threads per
// key row, looping over the G query heads and every q tile at or after the
// diagonal; dk and dv accumulate in registers (no atomics, deterministic) and
// are rounded to the input dtype once, at the end.
//
// What bounds it on this card: the work is 4 (K2) or 3 (K3) products of
// 2*D flops per kept pair against ~2 bytes per element of q, k, v, dO and
// the gradients, so the bf16 tensor-core rate bounds both. This first
// version does the products with scalar f32 FMAs out of shared memory, like
// K1, so shared-memory load bandwidth bounds it in practice: 16-byte shared
// loads, rows padded by 4 floats, scores in registers and only P / dS passed
// through shared memory within a warp. K2 has few blocks (B * Hkv * S / 64)
// and its first kv tiles do the most work, so it fills the card poorly;
// tensor cores and a better split come in a later version.

#include "flash_common.cuh"

namespace {

using namespace areal_flash;

constexpr int kRows = kThreads / 4;  // rows of a tile a block works on at once
static_assert(kRows == kBlockQ && kRows == kBlockKV, "one row per thread quad");

template <int D>
constexpr size_t dq_smem_bytes() {
  // q, dO, k, v tiles [64][D + 4] f32, dS tile [64][64 + 4] f32, two seg vectors.
  return sizeof(float) * (4 * kRows * (D + kPad) + kRows * (kRows + kPad)) +
         sizeof(int) * 2 * kRows;
}

template <int D>
constexpr size_t dkv_smem_bytes() {
  // k, v, q, dO tiles [64][D + 4] f32, P/dS tile [64][64 + 4] f32, lse and di
  // of the q tile, two seg vectors.
  return sizeof(float) * (4 * kRows * (D + kPad) + kRows * (kRows + kPad) + 2 * kRows) +
         sizeof(int) * 2 * kRows;
}

// Loads rows [r0, r0 + 64) of one head of a [B, L, H, D] tensor into a
// [64][D + 4] f32 tile; rows at or past `len` are zeros.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* base, size_t row_stride, int r0,
                                          int len) {
  constexpr int LD = D + kPad;
  for (int idx = threadIdx.x; idx < kRows * D; idx += kThreads) {
    const int r = idx / D, c = idx % D, t = r0 + r;
    dst[r * LD + c] = t < len ? to_f32(base[(size_t)t * row_stride + c]) : 0.f;
  }
}

// acc[4c + e] += sum_j w[j] * tile[j][4*quarter + 16c + e], with the 64
// weights w of this thread's row read from shared memory as float4s.
template <int D>
__device__ __forceinline__ void accumulate_rows(float* acc, const float* w_row, const float* tile,
                                                int quarter) {
  constexpr int LD = D + kPad;
  const float4* w4 = reinterpret_cast<const float4*>(w_row);
  for (int j4 = 0; j4 < kRows / 4; ++j4) {
    const float4 wv = w4[j4];
    const float wj[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const float4* t_row = reinterpret_cast<const float4*>(tile + (4 * j4 + jj) * LD);
#pragma unroll
      for (int c = 0; c < D / 16; ++c) {
        const float4 tv = t_row[quarter + 4 * c];
        acc[4 * c + 0] = fmaf(wj[jj], tv.x, acc[4 * c + 0]);
        acc[4 * c + 1] = fmaf(wj[jj], tv.y, acc[4 * c + 1]);
        acc[4 * c + 2] = fmaf(wj[jj], tv.z, acc[4 * c + 2]);
        acc[4 * c + 3] = fmaf(wj[jj], tv.w, acc[4 * c + 3]);
      }
    }
  }
}

// a[m] = own_a . others_a[quarter + 4m], b[m] = own_b . others_b[quarter + 4m]:
// the two dot products of this thread's row against 16 rows of the other
// side (scores and dP share the loop).
template <int D>
__device__ __forceinline__ void dot_rows(float* a, float* b, const float* own_a, const float* own_b,
                                         const float* others_a, const float* others_b,
                                         int quarter) {
  constexpr int LD = D + kPad;
  constexpr int M = kRows / 4;
#pragma unroll
  for (int m = 0; m < M; ++m) a[m] = b[m] = 0.f;
  const float4* oa = reinterpret_cast<const float4*>(own_a);
  const float4* ob = reinterpret_cast<const float4*>(own_b);
#pragma unroll 2
  for (int d4 = 0; d4 < D / 4; ++d4) {
    const float4 x = oa[d4];
    const float4 y = ob[d4];
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const float4 u = reinterpret_cast<const float4*>(others_a + (quarter + 4 * m) * LD)[d4];
      const float4 w = reinterpret_cast<const float4*>(others_b + (quarter + 4 * m) * LD)[d4];
      a[m] = fmaf(x.x, u.x, fmaf(x.y, u.y, fmaf(x.z, u.z, fmaf(x.w, u.w, a[m]))));
      b[m] = fmaf(y.x, w.x, fmaf(y.y, w.y, fmaf(y.z, w.z, fmaf(y.w, w.w, b[m]))));
    }
  }
}

// ---------------- K3: dq ----------------

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const int* __restrict__ q_seg, const int* __restrict__ kv_seg,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ di, T* __restrict__ dq, int T_len, int S_len, int Hq,
                    int Hkv, int causal, float scale) {
  constexpr int LD = D + kPad;
  constexpr int LDP = kRows + kPad;
  constexpr int M = kRows / 4;  // keys per thread per tile
  constexpr int DPT = D / 4;    // gradient dims per thread

  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);
  float* do_s = q_s + kRows * LD;
  float* k_s = do_s + kRows * LD;
  float* v_s = k_s + kRows * LD;
  float* ds_s = v_s + kRows * LD;
  int* qseg_s = reinterpret_cast<int*>(ds_s + kRows * LDP);
  int* kseg_s = qseg_s + kRows;

  const int tid = threadIdx.x;
  const int row = tid >> 2;
  const int quarter = tid & 3;
  // Causal tiles near the end of the row do the most work: start them first.
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBlockQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);

  const size_t q_stride = (size_t)Hq * D;
  const size_t kv_stride = (size_t)Hkv * D;
  const T* k_base = k + (size_t)b * S_len * kv_stride + (size_t)hk * D;
  const T* v_base = v + (size_t)b * S_len * kv_stride + (size_t)hk * D;
  load_tile<T, D>(q_s, q + (size_t)b * T_len * q_stride + (size_t)h * D, q_stride, q0, T_len);
  load_tile<T, D>(do_s, dout + (size_t)b * T_len * q_stride + (size_t)h * D, q_stride, q0, T_len);
  if (tid < kRows) {
    const int t = q0 + tid;
    qseg_s[tid] = t < T_len ? q_seg[(size_t)b * T_len + t] : 0;
  }
  __syncthreads();

  const int i_glob = q0 + row;
  const int my_seg = qseg_s[row];
  const float scale_log2 = scale * kLog2e;
  float lse2 = -INFINITY, my_di = 0.f;
  if (i_glob < T_len) {
    const size_t at = ((size_t)b * Hq + h) * T_len + i_glob;
    lse2 = lse[at] * kLog2e;  // stays -inf for rows without a valid key
    my_di = di[at];
  }
  const bool live = my_seg != 0 && lse2 > -INFINITY;
  float acc[DPT];
#pragma unroll
  for (int c = 0; c < DPT; ++c) acc[c] = 0.f;

  int kv_end = S_len;
  if (causal) kv_end = min(S_len, min(q0 + kBlockQ, T_len));

  for (int k0 = 0; k0 < kv_end; k0 += kBlockKV) {
    load_tile<T, D>(k_s, k_base, kv_stride, k0, S_len);
    load_tile<T, D>(v_s, v_base, kv_stride, k0, S_len);
    if (tid < kRows) {
      const int s = k0 + tid;
      kseg_s[tid] = s < S_len ? kv_seg[(size_t)b * S_len + s] : 0;
    }
    __syncthreads();

    float sc[M], dp[M];
    dot_rows<D>(sc, dp, q_s + row * LD, do_s + row * LD, k_s, v_s, quarter);
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const int j = quarter + 4 * m;
      const int s = k0 + j;
      const bool ok = live && s < S_len && kseg_s[j] == my_seg && (!causal || s <= i_glob);
      const float p = ok ? exp2f(sc[m] * scale_log2 - lse2) : 0.f;
      ds_s[row * LDP + j] = p * (dp[m] - my_di);
    }
    // Row `row`'s dS was written by the four threads of its quad, all in
    // this warp: a warp barrier is enough before reading it back.
    __syncwarp();
    accumulate_rows<D>(acc, ds_s + row * LDP, k_s, quarter);
    __syncthreads();  // the next tile overwrites k_s, v_s, kseg_s
  }

  if (i_glob < T_len) {
    T* o_row = dq + ((size_t)b * T_len + i_glob) * q_stride + (size_t)h * D;
#pragma unroll
    for (int c = 0; c < D / 16; ++c) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        o_row[4 * quarter + 16 * c + e] = from_f32<T>(acc[4 * c + e] * scale);
      }
    }
  }
}

// ---------------- K2: dk, dv ----------------

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const int* __restrict__ q_seg, const int* __restrict__ kv_seg,
                     const T* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ di, T* __restrict__ dk, T* __restrict__ dv,
                     int T_len, int S_len, int Hq, int Hkv, int causal, float scale) {
  constexpr int LD = D + kPad;
  constexpr int LDP = kRows + kPad;
  constexpr int M = kRows / 4;  // queries per thread per tile
  constexpr int DPT = D / 4;

  extern __shared__ float4 smem4[];
  float* k_s = reinterpret_cast<float*>(smem4);
  float* v_s = k_s + kRows * LD;
  float* q_s = v_s + kRows * LD;
  float* do_s = q_s + kRows * LD;
  float* p_s = do_s + kRows * LD;
  float* lse2_s = p_s + kRows * LDP;
  float* di_s = lse2_s + kRows;
  int* qseg_s = reinterpret_cast<int*>(di_s + kRows);
  int* kseg_s = qseg_s + kRows;

  const int tid = threadIdx.x;
  const int krow = tid >> 2;
  const int quarter = tid & 3;
  const int k0 = blockIdx.x * kBlockKV;  // the first kv tiles do the most work
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int G = Hq / Hkv;

  const size_t q_stride = (size_t)Hq * D;
  const size_t kv_stride = (size_t)Hkv * D;
  load_tile<T, D>(k_s, k + (size_t)b * S_len * kv_stride + (size_t)hk * D, kv_stride, k0, S_len);
  load_tile<T, D>(v_s, v + (size_t)b * S_len * kv_stride + (size_t)hk * D, kv_stride, k0, S_len);
  if (tid < kRows) {
    const int s = k0 + tid;
    kseg_s[tid] = s < S_len ? kv_seg[(size_t)b * S_len + s] : 0;
  }
  // (the first loop iteration's barrier publishes these tiles)

  const int j_glob = k0 + krow;
  const float scale_log2 = scale * kLog2e;
  float dk_acc[DPT], dv_acc[DPT];
#pragma unroll
  for (int c = 0; c < DPT; ++c) dk_acc[c] = dv_acc[c] = 0.f;

  // Causal: rows before this kv tile's first q tile keep none of its columns.
  const int q_begin = causal ? (k0 / kBlockQ) * kBlockQ : 0;
  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
    const T* q_base = q + (size_t)b * T_len * q_stride + (size_t)h * D;
    const T* do_base = dout + (size_t)b * T_len * q_stride + (size_t)h * D;
    const size_t lse_row = ((size_t)b * Hq + h) * T_len;
    for (int q0 = q_begin; q0 < T_len; q0 += kBlockQ) {
      __syncthreads();  // the previous tile's reads of q_s, do_s, p_s are done
      load_tile<T, D>(q_s, q_base, q_stride, q0, T_len);
      load_tile<T, D>(do_s, do_base, q_stride, q0, T_len);
      if (tid < kRows) {
        const int t = q0 + tid;
        const bool in = t < T_len;
        qseg_s[tid] = in ? q_seg[(size_t)b * T_len + t] : 0;
        lse2_s[tid] = in ? lse[lse_row + t] * kLog2e : -INFINITY;
        di_s[tid] = in ? di[lse_row + t] : 0.f;
      }
      __syncthreads();

      const int my_seg = kseg_s[krow];
      float p[M], dp[M];
      dot_rows<D>(p, dp, k_s + krow * LD, v_s + krow * LD, q_s, do_s, quarter);
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const int i = quarter + 4 * m;
        const int t = q0 + i;
        const bool ok = my_seg != 0 && j_glob < S_len && qseg_s[i] == my_seg &&
                        lse2_s[i] > -INFINITY && (!causal || j_glob <= t);
        p[m] = ok ? exp2f(p[m] * scale_log2 - lse2_s[i]) : 0.f;
        p_s[krow * LDP + i] = p[m];
      }
      // Row `krow` of P is written and read by its own quad, within a warp.
      __syncwarp();
      accumulate_rows<D>(dv_acc, p_s + krow * LDP, do_s, quarter);
      __syncwarp();  // every lane has read P before dS overwrites it
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const int i = quarter + 4 * m;
        p_s[krow * LDP + i] = p[m] * (dp[m] - di_s[i]);
      }
      __syncwarp();
      accumulate_rows<D>(dk_acc, p_s + krow * LDP, q_s, quarter);
    }
  }

  if (j_glob < S_len) {
    const size_t at = ((size_t)b * S_len + j_glob) * kv_stride + (size_t)hk * D;
#pragma unroll
    for (int c = 0; c < D / 16; ++c) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = 4 * quarter + 16 * c + e;
        dk[at + d] = from_f32<T>(dk_acc[4 * c + e] * scale);
        dv[at + d] = from_f32<T>(dv_acc[4 * c + e]);
      }
    }
  }
}

struct BwdArgs {
  const void *q, *k, *v;
  const int *q_seg, *kv_seg;
  const void* dout;
  const float *lse, *di;
  void *dq, *dk, *dv;
  int B, T_len, S_len, Hq, Hkv, causal;
  float scale;
  cudaStream_t stream;
};

template <typename T, int D>
cudaError_t launch_dq(const BwdArgs& a) {
  constexpr size_t smem = dq_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.T_len + kBlockQ - 1) / kBlockQ, a.Hq, a.B);
  flash_bwd_dq_kernel<T, D><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      a.q_seg, a.kv_seg, static_cast<const T*>(a.dout), a.lse, a.di, static_cast<T*>(a.dq),
      a.T_len, a.S_len, a.Hq, a.Hkv, a.causal, a.scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const BwdArgs& a) {
  constexpr size_t smem = dkv_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.S_len + kBlockKV - 1) / kBlockKV, a.Hkv, a.B);
  flash_bwd_dkv_kernel<T, D><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      a.q_seg, a.kv_seg, static_cast<const T*>(a.dout), a.lse, a.di, static_cast<T*>(a.dk),
      static_cast<T*>(a.dv), a.T_len, a.S_len, a.Hq, a.Hkv, a.causal, a.scale);
  return cudaGetLastError();
}

// Picks the (dtype, head_dim) instance of `Launch`: dtype 0 = float32,
// 1 = bfloat16, 2 = float16; head_dim 64 or 128.
template <template <typename, int> class Launch>
cudaError_t dispatch(int D, int dtype, const BwdArgs& a) {
  if (D != 64 && D != 128) return cudaErrorInvalidValue;
  switch (dtype) {
    case 0: return D == 64 ? Launch<float, 64>::run(a) : Launch<float, 128>::run(a);
    case 1:
      return D == 64 ? Launch<__nv_bfloat16, 64>::run(a) : Launch<__nv_bfloat16, 128>::run(a);
    case 2: return D == 64 ? Launch<__half, 64>::run(a) : Launch<__half, 128>::run(a);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, int D>
struct DqLaunch {
  static cudaError_t run(const BwdArgs& a) { return launch_dq<T, D>(a); }
};

template <typename T, int D>
struct DkvLaunch {
  static cudaError_t run(const BwdArgs& a) { return launch_dkv<T, D>(a); }
};

BwdArgs make_args(const void* q, const void* k, const void* v, const void* q_seg,
                  const void* kv_seg, const void* dout, const void* lse, const void* di, void* dq,
                  void* dk, void* dv, int B, int T_len, int S_len, int Hq, int Hkv, int causal,
                  float scale, void* stream) {
  return BwdArgs{q, k, v, static_cast<const int*>(q_seg), static_cast<const int*>(kv_seg), dout,
                 static_cast<const float*>(lse), static_cast<const float*>(di), dq, dk, dv, B,
                 T_len, S_len, Hq, Hkv, causal, scale, static_cast<cudaStream_t>(stream)};
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. q, dout, dq [B,T,Hq,D];
// k, v, dk, dv [B,S,Hkv,D]; segment ids int32 [B,T] / [B,S]; lse and di f32
// [B,Hq,T]; all contiguous. Each returns the cudaError_t of its launch.
int areal_flash_attention_bwd_dq(const void* q, const void* k, const void* v, const void* q_seg,
                                 const void* kv_seg, const void* dout, const void* lse,
                                 const void* di, void* dq, int B, int T_len, int S_len, int Hq,
                                 int Hkv, int D, int dtype, int causal, float scale,
                                 void* stream) {
  if (B <= 0 || T_len <= 0 || Hq <= 0) return cudaSuccess;
  if (Hkv <= 0 || Hq % Hkv != 0 || S_len < 0) return cudaErrorInvalidValue;
  const BwdArgs a = make_args(q, k, v, q_seg, kv_seg, dout, lse, di, dq, nullptr, nullptr, B,
                              T_len, S_len, Hq, Hkv, causal, scale, stream);
  return dispatch<DqLaunch>(D, dtype, a);
}

int areal_flash_attention_bwd_dkv(const void* q, const void* k, const void* v, const void* q_seg,
                                  const void* kv_seg, const void* dout, const void* lse,
                                  const void* di, void* dk, void* dv, int B, int T_len,
                                  int S_len, int Hq, int Hkv, int D, int dtype, int causal,
                                  float scale, void* stream) {
  if (B <= 0 || S_len <= 0 || Hkv <= 0) return cudaSuccess;
  if (Hq % Hkv != 0 || T_len < 0) return cudaErrorInvalidValue;
  const BwdArgs a = make_args(q, k, v, q_seg, kv_seg, dout, lse, di, nullptr, dk, dv, B, T_len,
                              S_len, Hq, Hkv, causal, scale, stream);
  return dispatch<DkvLaunch>(D, dtype, a);
}

}  // extern "C"
