// Packed segment-causal flash attention, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel behind areal_tpu/ops/pallas/flash_attention.py:200
// `flash_attention` (which calls the Pallas library kernel's forward,
// `_flash_attention_impl`): softmax(scale * q k^T + mask) v with an online
// softmax over KV tiles. A query row attends a key column when both carry
// the same nonzero segment id and, when causal, the column index is <= the
// row index (causal by index, exactly as the TPU kernel).
//
// Differences from the TPU wrapper: GQA reads kv head h / G directly (no
// repeat of K/V); head_dim 64 and 128 are template cases (no padding to 128
// lanes); any T and S work (ragged tails are masked); KV tiles wholly in the
// causal future are never loaded; rows without a valid key (pad queries,
// segment 0) come out as exact zeros with logsumexp -inf.
//
// What bounds it on this card: at prefill and train shapes (T = S =
// 512..1792, D = 64) the work is ~4*D flops per kept (q, k) pair against ~2
// bytes per element of q, k, v, o, so the bf16 tensor-core rate bounds it.
//
// bf16 / fp16 (`flash_fwd_mma_kernel`, the main path): FlashAttention-2's
// forward on tensor cores with mma.sync.m16n8k16 (f32 accumulate). One
// block per (64-row q tile, q head, batch row), 4 warps of 16 query rows.
// The Q fragments are loaded once into registers; S = Q K^T and the online
// softmax stay in the accumulator fragments (the row max and sum reduce over
// the four lanes that own a row); P is rounded to the input type in
// registers and is the A operand of P V directly (the TPU kernel rounds it
// the same way, `p.astype(v.dtype)`), with V read through ldmatrix.trans.
// K and V tiles stay 16-bit in shared memory, XOR-swizzled against bank
// conflicts and double-buffered with 16-byte cp.async, so the next kept
// tile is in flight while this one computes. Before the loop the block
// lists the kv tiles it needs: causal-future tiles and tiles whose range of
// nonzero segment ids does not overlap the q tile's (no shared id, for any
// ids; pad-only tiles included) are never loaded. The blocks of the last q
// tiles, which do the most work under causal masking, start first.
//
// float32 (`flash_fwd_kernel`, dtype code 0): the scalar f32-FMA kernel,
// kept as the exact-f32 specialisation (TF32 tensor cores would not hold
// float32's tolerances); the model runs bf16. Layout: one block per
// (64-row q tile, q head, batch row), 256 threads, four threads per query
// row. Thread (row, quarter) computes the scores of keys quarter + 4*m of
// each 64-key tile and owns head dims 4*quarter + 16*c + {0..3} of the
// output accumulator; 16-byte shared loads, rows padded by 4 floats.

#include <type_traits>

#include "flash_common.cuh"

namespace {

using namespace areal_flash;

template <int D>
constexpr size_t smem_bytes() {
  // q, k, v tiles [64][D + 4] f32, P tile [64][64 + 4] f32, two seg vectors.
  return sizeof(float) * (3 * kBlockQ * (D + kPad) + kBlockQ * (kBlockKV + kPad)) +
         sizeof(int) * (kBlockQ + kBlockKV);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const int* __restrict__ q_seg, const int* __restrict__ kv_seg,
                 T* __restrict__ out, float* __restrict__ lse, int T_len, int S_len, int Hq,
                 int Hkv, int causal, float scale_log2) {
  constexpr int LD = D + kPad;
  constexpr int LDP = kBlockKV + kPad;
  constexpr int KPT = kBlockKV / 4;  // keys per thread per tile
  constexpr int DPT = D / 4;         // output dims per thread

  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);
  float* k_s = q_s + kBlockQ * LD;
  float* v_s = k_s + kBlockKV * LD;
  float* p_s = v_s + kBlockKV * LD;
  int* qseg_s = reinterpret_cast<int*>(p_s + kBlockQ * LDP);
  int* kseg_s = qseg_s + kBlockQ;

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
  const T* q_base = q + (size_t)b * T_len * q_stride + (size_t)h * D;
  const T* k_base = k + (size_t)b * S_len * kv_stride + (size_t)hk * D;
  const T* v_base = v + (size_t)b * S_len * kv_stride + (size_t)hk * D;

  // Q tile, pre-scaled into the log2 domain of exp2f.
  for (int idx = tid; idx < kBlockQ * D; idx += kThreads) {
    const int r = idx / D, c = idx % D, t = q0 + r;
    q_s[r * LD + c] = t < T_len ? to_f32(q_base[(size_t)t * q_stride + c]) * scale_log2 : 0.f;
  }
  if (tid < kBlockQ) {
    const int t = q0 + tid;
    qseg_s[tid] = t < T_len ? q_seg[(size_t)b * T_len + t] : 0;
  }
  __syncthreads();

  const int i_glob = q0 + row;
  const int my_seg = qseg_s[row];
  float acc[DPT];
#pragma unroll
  for (int c = 0; c < DPT; ++c) acc[c] = 0.f;
  float m_run = -INFINITY;
  float l_run = 0.f;

  int kv_end = S_len;
  if (causal) kv_end = min(S_len, min(q0 + kBlockQ, T_len));

  for (int k0 = 0; k0 < kv_end; k0 += kBlockKV) {
    for (int idx = tid; idx < kBlockKV * D; idx += kThreads) {
      const int r = idx / D, c = idx % D, s = k0 + r;
      const bool in = s < S_len;
      k_s[r * LD + c] = in ? to_f32(k_base[(size_t)s * kv_stride + c]) : 0.f;
      v_s[r * LD + c] = in ? to_f32(v_base[(size_t)s * kv_stride + c]) : 0.f;
    }
    if (tid < kBlockKV) {
      const int s = k0 + tid;
      kseg_s[tid] = s < S_len ? kv_seg[(size_t)b * S_len + s] : 0;
    }
    __syncthreads();

    // Scores of keys quarter + 4*m: each float4 of the q row feeds KPT keys.
    float sc[KPT];
#pragma unroll
    for (int m = 0; m < KPT; ++m) sc[m] = 0.f;
    const float4* q_row = reinterpret_cast<const float4*>(q_s + row * LD);
#pragma unroll 4
    for (int d4 = 0; d4 < D / 4; ++d4) {
      const float4 qv = q_row[d4];
#pragma unroll
      for (int m = 0; m < KPT; ++m) {
        const float4 kv = reinterpret_cast<const float4*>(k_s + (quarter + 4 * m) * LD)[d4];
        sc[m] = fmaf(qv.x, kv.x, sc[m]);
        sc[m] = fmaf(qv.y, kv.y, sc[m]);
        sc[m] = fmaf(qv.z, kv.z, sc[m]);
        sc[m] = fmaf(qv.w, kv.w, sc[m]);
      }
    }

    float tile_max = -INFINITY;
#pragma unroll
    for (int m = 0; m < KPT; ++m) {
      const int j = quarter + 4 * m;
      const int s = k0 + j;
      const bool ok = my_seg != 0 && s < S_len && kseg_s[j] == my_seg && (!causal || s <= i_glob);
      sc[m] = ok ? sc[m] : -INFINITY;
      tile_max = fmaxf(tile_max, sc[m]);
    }
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 1));
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 2));
    const float m_new = fmaxf(m_run, tile_max);
    // A row with no valid key so far keeps m = -inf: subtract 0 instead, so
    // exp2f never sees -inf - -inf.
    const float m_use = m_new == -INFINITY ? 0.f : m_new;
    const float alpha = exp2f(m_run - m_use);
    float p_sum = 0.f;
#pragma unroll
    for (int m = 0; m < KPT; ++m) {
      const float p = exp2f(sc[m] - m_use);
      p_sum += p;
      p_s[row * LDP + quarter + 4 * m] = p;
    }
    p_sum += __shfl_xor_sync(0xffffffffu, p_sum, 1);
    p_sum += __shfl_xor_sync(0xffffffffu, p_sum, 2);
    l_run = l_run * alpha + p_sum;
    m_run = m_new;
    // Row `row`'s P was written by the four threads of its quad, all in
    // this warp: a warp barrier is enough before reading it back.
    __syncwarp();

#pragma unroll
    for (int c = 0; c < DPT; ++c) acc[c] *= alpha;
    const float4* p_row = reinterpret_cast<const float4*>(p_s + row * LDP);
    for (int j4 = 0; j4 < kBlockKV / 4; ++j4) {
      const float4 p4 = p_row[j4];
      const float pj[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float4* v_row = reinterpret_cast<const float4*>(v_s + (4 * j4 + jj) * LD);
#pragma unroll
        for (int c = 0; c < D / 16; ++c) {
          const float4 vv = v_row[quarter + 4 * c];
          acc[4 * c + 0] = fmaf(pj[jj], vv.x, acc[4 * c + 0]);
          acc[4 * c + 1] = fmaf(pj[jj], vv.y, acc[4 * c + 1]);
          acc[4 * c + 2] = fmaf(pj[jj], vv.z, acc[4 * c + 2]);
          acc[4 * c + 3] = fmaf(pj[jj], vv.w, acc[4 * c + 3]);
        }
      }
    }
    __syncthreads();  // the next tile overwrites k_s, v_s, kseg_s
  }

  if (i_glob < T_len) {
    const bool any = l_run > 0.f;
    const float inv = any ? 1.f / l_run : 0.f;
    T* o_row = out + ((size_t)b * T_len + i_glob) * q_stride + (size_t)h * D;
#pragma unroll
    for (int c = 0; c < D / 16; ++c) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        o_row[4 * quarter + 16 * c + e] = from_f32<T>(acc[4 * c + e] * inv);
      }
    }
    if (quarter == 0) {
      lse[((size_t)b * Hq + h) * T_len + i_glob] =
          any ? (m_run + log2f(l_run)) * kLn2 : -INFINITY;
    }
  }
}

// ---------------- bf16 / fp16: tensor cores ----------------

template <int D>
size_t mma_smem_bytes(int n_kv_tiles) {
  // Q tile, K and V tiles x2 (16-bit); q segment ids, kv segment ids x2, the
  // tile count and the list of kept kv tiles.
  return 2 * (kBlockQ * D + 4 * kBlockKV * D) +
         sizeof(int) * (kBlockQ + 2 * kBlockKV + 1 + n_kv_tiles);
}

template <typename T, int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_fwd_mma_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const int* __restrict__ q_seg, const int* __restrict__ kv_seg,
                     T* __restrict__ out, float* __restrict__ lse, int T_len, int S_len, int Hq,
                     int Hkv, int causal, float scale_log2) {
  constexpr int NB = kBlockKV / 8;  // key n-blocks of a tile
  constexpr int KD = D / 16;        // 16-wide steps over the head dim

  extern __shared__ float4 smem4[];
  T* q_s = reinterpret_cast<T*>(smem4);
  T* k_s = q_s + kBlockQ * D;    // [2][64][D]
  T* v_s = k_s + 2 * kBlockKV * D;  // [2][64][D]
  int* qseg_s = reinterpret_cast<int*>(v_s + 2 * kBlockKV * D);
  int* kseg_s = qseg_s + kBlockQ;  // [2][64]
  int* count_s = kseg_s + 2 * kBlockKV;
  int* list_s = count_s + 1;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n_qt = (T_len + kBlockQ - 1) / kBlockQ;
  const int per_tile = gridDim.x / n_qt;  // Hq * B blocks share a q tile index
  // Causal tiles near the end of the row do the most work: start them first.
  const int q0 = (n_qt - 1 - (int)blockIdx.x / per_tile) * kBlockQ;
  const int h = blockIdx.x % per_tile % Hq;
  const int b = blockIdx.x % per_tile / Hq;
  const int hk = h / (Hq / Hkv);

  const size_t q_stride = (size_t)Hq * D;
  const size_t kv_stride = (size_t)Hkv * D;
  const T* k_base = k + (size_t)b * S_len * kv_stride + (size_t)hk * D;
  const T* v_base = v + (size_t)b * S_len * kv_stride + (size_t)hk * D;
  const int* qseg_row = q_seg + (size_t)b * T_len;
  const int* kseg_row = kv_seg + (size_t)b * S_len;

  load_tile_async<T, kBlockQ, D>(q_s, q + (size_t)b * T_len * q_stride + (size_t)h * D, q_stride,
                                 q0, T_len);
  cp_async_commit();
  if (tid < kBlockQ) qseg_s[tid] = q0 + tid < T_len ? qseg_row[q0 + tid] : 0;

  // The kv tiles this q tile needs: not wholly in the causal future, and
  // sharing a range of nonzero segment ids.
  const SegRange q_range = warp_seg_range(qseg_row, q0, kBlockQ, T_len);
  const int n_kv = (S_len + kBlockKV - 1) / kBlockKV;
  const int q_last = min(q0 + kBlockQ, T_len) - 1;
  const int kv_end = causal ? min(n_kv, q_last / kBlockKV + 1) : n_kv;
  const int n = build_tile_list(list_s, count_s, 0, kv_end, [&](int t) {
    return ranges_overlap(q_range, warp_seg_range(kseg_row, t * kBlockKV, kBlockKV, S_len));
  });

  auto load_kv = [&](int i, int buf) {
    const int k0 = list_s[i] * kBlockKV;
    load_tile_async<T, kBlockKV, D>(k_s + buf * kBlockKV * D, k_base, kv_stride, k0, S_len);
    load_tile_async<T, kBlockKV, D>(v_s + buf * kBlockKV * D, v_base, kv_stride, k0, S_len);
    if (tid < kBlockKV) {
      const int s = k0 + tid;
      cp_async_4(kseg_s + buf * kBlockKV + tid, kseg_row + (s < S_len ? s : 0), s < S_len);
    }
  };
  if (n > 0) load_kv(0, 0);
  cp_async_commit();
  cp_async_wait<1>();  // this thread's part of the Q tile has landed
  __syncthreads();

  uint32_t qf[KD][4];  // this warp's 16 query rows, the A operand of S = Q K^T
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) ldmatrix_x4(qf[kk], a_frag_addr<D>(q_s, warp * 16, kk, lane));

  // This lane's two rows (r = 0, 1) and its columns 2 (lane % 4) + {0, 1} of
  // every 8-wide n-block.
  const int row_l = warp * 16 + (lane >> 2);
  const int rows[2] = {q0 + row_l, q0 + row_l + 8};
  const int segs[2] = {qseg_s[row_l], qseg_s[row_l + 8]};
  const int col_l = 2 * (lane & 3);
  float o[D / 8][4];
#pragma unroll
  for (int db = 0; db < D / 8; ++db) o[db][0] = o[db][1] = o[db][2] = o[db][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};  // this lane's part of each row's sum

  for (int it = 0; it < n; ++it) {
    const int buf = it & 1;
    if (it + 1 < n) load_kv(it + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // tile `it` has landed
    __syncthreads();
    const T* kt = k_s + buf * kBlockKV * D;
    const T* vt = v_s + buf * kBlockKV * D;
    const int* ks = kseg_s + buf * kBlockKV;
    const int k0 = list_s[it] * kBlockKV;

    float s[NB][4];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) s[nb][0] = s[nb][1] = s[nb][2] = s[nb][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
      for (int nb2 = 0; nb2 < NB / 2; ++nb2) {
        uint32_t bf[4];
        ldmatrix_x4(bf, b_frag_addr<D>(kt, nb2 * 16, kk, lane));
        mma_16816<T>(s[2 * nb2], qf[kk], bf[0], bf[1]);
        mma_16816<T>(s[2 * nb2 + 1], qf[kk], bf[2], bf[3]);
      }
    }

    // Mask, scale into the log2 domain, and the online softmax.
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int jl = nb * 8 + col_l + (e & 1);
        const bool ok = segs[r] != 0 && ks[jl] == segs[r] && (!causal || k0 + jl <= rows[r]);
        s[nb][e] = ok ? s[nb][e] * scale_log2 : -INFINITY;
        mx[r] = fmaxf(mx[r], s[nb][e]);
      }
    }
    float m_use[2], alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_run[r], mx[r]);
      // A row with no kept key so far keeps m = -inf: subtract 0 instead, so
      // exp2f never sees -inf - -inf.
      m_use[r] = m_new == -INFINITY ? 0.f : m_new;
      alpha[r] = exp2f(m_run[r] - m_use[r]);
      m_run[r] = m_new;
      l_run[r] *= alpha[r];
    }
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nb][e] = exp2f(s[nb][e] - m_use[e >> 1]);
        l_run[e >> 1] += s[nb][e];
      }
    }
#pragma unroll
    for (int db = 0; db < D / 8; ++db) {
      o[db][0] *= alpha[0];
      o[db][1] *= alpha[0];
      o[db][2] *= alpha[1];
      o[db][3] *= alpha[1];
    }

    // O += P V, P from registers, V through ldmatrix.trans.
#pragma unroll
    for (int kk = 0; kk < kBlockKV / 16; ++kk) {
      uint32_t pa[4];
      acc_to_a<T>(pa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int db2 = 0; db2 < D / 16; ++db2) {
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, bt_frag_addr<D>(vt, kk * 16, db2, lane));
        mma_16816<T>(o[2 * db2], pa, bf[0], bf[1]);
        mma_16816<T>(o[2 * db2 + 1], pa, bf[2], bf[3]);
      }
    }
    __syncthreads();  // the next iteration's loads overwrite this buffer
  }
  cp_async_wait<0>();  // nothing left in flight (a block with no kept tile)

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    if (rows[r] >= T_len) continue;
    const float inv = l > 0.f ? 1.f / l : 0.f;
    T* o_row = out + ((size_t)b * T_len + rows[r]) * q_stride + (size_t)h * D + col_l;
#pragma unroll
    for (int db = 0; db < D / 8; ++db) {
      *reinterpret_cast<uint32_t*>(o_row + db * 8) =
          pack2<T>(o[db][2 * r] * inv, o[db][2 * r + 1] * inv);
    }
    if ((lane & 3) == 0) {
      lse[((size_t)b * Hq + h) * T_len + rows[r]] =
          l > 0.f ? (m_run[r] + log2f(l)) * kLn2 : -INFINITY;
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const int* q_seg,
                   const int* kv_seg, void* out, float* lse, int B, int T_len, int S_len, int Hq,
                   int Hkv, int causal, float scale, cudaStream_t stream) {
  if constexpr (std::is_same<T, float>::value) {
    constexpr size_t smem = smem_bytes<D>();
    cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, D>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((T_len + kBlockQ - 1) / kBlockQ, Hq, B);
    flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), q_seg,
        kv_seg, static_cast<T*>(out), lse, T_len, S_len, Hq, Hkv, causal, scale * kLog2e);
  } else {
    const size_t smem = mma_smem_bytes<D>((S_len + kBlockKV - 1) / kBlockKV);
    cudaError_t err = cudaFuncSetAttribute(flash_fwd_mma_kernel<T, D>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const int grid = (T_len + kBlockQ - 1) / kBlockQ * Hq * B;
    flash_fwd_mma_kernel<T, D><<<grid, kMmaThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), q_seg,
        kv_seg, static_cast<T*>(out), lse, T_len, S_len, Hq, Hkv, causal, scale * kLog2e);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dim(int D, const void* q, const void* k, const void* v, const int* q_seg,
                         const int* kv_seg, void* out, float* lse, int B, int T_len, int S_len,
                         int Hq, int Hkv, int causal, float scale, cudaStream_t stream) {
  switch (D) {
    case 64:
      return launch<T, 64>(q, k, v, q_seg, kv_seg, out, lse, B, T_len, S_len, Hq, Hkv, causal,
                           scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, q_seg, kv_seg, out, lse, B, T_len, S_len, Hq, Hkv, causal,
                            scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. q [B,T,Hq,D], k/v [B,S,Hkv,D],
// segment ids int32 [B,T] / [B,S], out like q, lse f32 [B,Hq,T]; all contiguous.
// Returns the cudaError_t of the launch (0 on success).
int areal_flash_attention_fwd(const void* q, const void* k, const void* v, const void* q_seg,
                              const void* kv_seg, void* out, void* lse, int B, int T_len,
                              int S_len, int Hq, int Hkv, int D, int dtype, int causal,
                              float scale, void* stream) {
  if (B <= 0 || T_len <= 0 || Hq <= 0) return cudaSuccess;
  if (Hkv <= 0 || Hq % Hkv != 0 || S_len < 0) return cudaErrorInvalidValue;
  const int* qs = static_cast<const int*>(q_seg);
  const int* ks = static_cast<const int*>(kv_seg);
  float* l = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return dispatch_dim<float>(D, q, k, v, qs, ks, out, l, B, T_len, S_len, Hq, Hkv, causal,
                                 scale, st);
    case 1:
      return dispatch_dim<__nv_bfloat16>(D, q, k, v, qs, ks, out, l, B, T_len, S_len, Hq, Hkv,
                                         causal, scale, st);
    case 2:
      return dispatch_dim<__half>(D, q, k, v, qs, ks, out, l, B, T_len, S_len, Hq, Hkv, causal,
                                  scale, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // extern "C"
