// tpumon native TSDB ingest kernel.
//
// C fast path for the columnar time-series store's write side
// (tpumon_torch/tsdb.py): batch quantization, downsample bucket accumulation
// and sealed-chunk encoding. The Python store stays the source of
// truth for all state — this kernel only transforms flat float64/float32
// buffers handed to it via ctypes, so the pure-Python fallback can be
// (and is, by test) bit-exact: every operation below mirrors a specific
// CPython expression, noted inline.
//
// Same contract as hostmon.cpp: pure C ABI, no pybind11, degrades to
// the Python implementation when the .so is absent (docs/resilience.md).
//
// Build: python -m tpumon_torch.native build (into build/tpumon_torch/native/)

#include <cmath>
#include <cstdint>
#include <cstring>

extern "C" {

// Python float.__round__ / C nearbyint both round half-to-even under the
// default FP environment; llrint keeps the integral result exact for the
// millisecond magnitudes involved (~2^41 << 2^53).
static inline int64_t round_half_even_ll(double x) { return llrint(x); }

// Mirror of CPython's float floor division (floatobject.c float_divmod):
// the bucket index `int(ts // step)` must match Python bit-for-bit, and
// naive floor(ts/step) differs from fmod-based floordiv in edge cases.
static double py_floordiv(double vx, double wx) {
  double mod = fmod(vx, wx);
  double div = (vx - mod) / wx;
  if (mod != 0.0) {
    if ((wx < 0) != (mod < 0)) {
      mod += wx;
      div -= 1.0;
    }
  }
  double floordiv;
  if (div != 0.0) {
    floordiv = floor(div);
    if (div - floordiv > 0.5) floordiv += 1.0;
  } else {
    floordiv = copysign(0.0, vx / wx);
  }
  return floordiv;
}

// Quantize a batch: timestamps onto the millisecond grid
// (round(ts*1000)/1000, half-even — tpumon_torch.tsdb.quantize_ts) and values
// through float32 (tsdb.quantize_val). Returns 1 when the quantized
// timestamps are non-decreasing AND none precedes last_ts (pass NaN for
// an empty tier), else 0 — the caller falls back to the per-point
// sorted-insert path on 0. Outputs are filled either way.
int32_t tpumon_tsdb_quantize(int64_t n, const double* ts, const double* vals,
                             double last_ts, double* ts_q, float* val_q) {
  int32_t ordered = 1;
  double prev = last_ts;  // NaN compares false with everything: no bound
  for (int64_t i = 0; i < n; i++) {
    double t = (double)round_half_even_ll(ts[i] * 1000.0) / 1000.0;
    ts_q[i] = t;
    val_q[i] = (float)vals[i];
    if (t < prev) ordered = 0;
    prev = t;
  }
  return ordered;
}

// Single-series downsample accumulation over an ordered, quantized
// batch. state = {bucket (NaN = no open bucket), bsum, bn}, updated in
// place; closed buckets are emitted as (mid-timestamp, raw mean) pairs
// — the caller appends them through the tier (which applies the f32
// value quantization, exactly like Downsample.flush). Returns the flush
// count (<= n). Mirrors Downsample.observe called per point, minus the
// per-point tier eviction the batch path defers to its end.
int64_t tpumon_tsdb_accum(int64_t n, const double* ts_q, const float* val_q,
                          double step, double* state, double* flush_ts,
                          double* flush_mean) {
  double bucket = state[0];
  double bsum = state[1];
  double bn = state[2];
  int64_t nf = 0;
  for (int64_t i = 0; i < n; i++) {
    double b = py_floordiv(ts_q[i], step);  // int(ts // step) as double
    if (bucket == bucket && b != bucket) {  // open bucket, boundary crossed
      if (bn != 0.0) {
        // Downsample.flush: quantize_ts((bucket + 0.5) * step), bsum / bn
        flush_ts[nf] =
            (double)round_half_even_ll((bucket + 0.5) * step * 1000.0) / 1000.0;
        flush_mean[nf] = bsum / bn;
        nf++;
      }
      bsum = 0.0;
      bn = 0.0;
    }
    bucket = b;
    bsum += (double)val_q[i];  // f32 -> f64 is exact; same add order as Python
    bn += 1.0;
  }
  state[0] = bucket;
  state[1] = bsum;
  state[2] = bn;
  return nf;
}

// Many-series accumulation: one point per series at one shared quantized
// timestamp (the sampler's per-chip tick shape — tpumon_torch/sampler.py
// _record_per_chip). slots[i] indexes the contiguous state columns
// (tsdb.AccumStore). Emits (slot, mid-ts, raw mean) per closed bucket;
// a series that skipped ticks flushes its stale bucket the next time it
// reports. Returns the flush count (<= n).
int64_t tpumon_tsdb_accum_many(int64_t n, double ts_q, const float* val_q,
                               const int32_t* slots, double step,
                               double* bucket_col, double* bsum_col,
                               double* bn_col, int32_t* flush_slot,
                               double* flush_ts, double* flush_mean) {
  double bnew = py_floordiv(ts_q, step);  // shared ts: one bucket for all
  int64_t nf = 0;
  for (int64_t i = 0; i < n; i++) {
    int32_t s = slots[i];
    double b = bucket_col[s];
    if (b == b && b != bnew) {
      if (bn_col[s] != 0.0) {
        flush_slot[nf] = s;
        flush_ts[nf] =
            (double)round_half_even_ll((b + 0.5) * step * 1000.0) / 1000.0;
        flush_mean[nf] = bsum_col[s] / bn_col[s];
        nf++;
      }
      bsum_col[s] = 0.0;
      bn_col[s] = 0.0;
    }
    bucket_col[s] = bnew;
    bsum_col[s] += (double)val_q[i];
    bn_col[s] += 1.0;
  }
  return nf;
}

static inline int64_t put_uvarint(uint8_t* out, int64_t pos, uint64_t u) {
  while (u >= 0x80) {
    out[pos++] = (uint8_t)((u & 0x7F) | 0x80);
    u >>= 7;
  }
  out[pos++] = (uint8_t)u;
  return pos;
}

static inline uint64_t zigzag64(int64_t v) {
  return ((uint64_t)(v << 1)) ^ (uint64_t)(v >> 63);
}

// Seal the head columns into one compressed chunk: delta-of-delta
// zigzag-varint millisecond timestamps + XOR-with-previous uvarint f32
// bit patterns — byte-identical to tsdb.encode_chunk over
// [int(round(t*1000)) ...] / [f32bits(v) ...]. Writes first/last ms out
// (the Chunk bounds). Returns the encoded length, or -1 if cap is too
// small (caller sizes cap at 16 + 15*n, which varints cannot exceed).
int64_t tpumon_tsdb_seal_encode(int64_t n, const double* head_ts,
                                const float* head_val, uint8_t* out,
                                int64_t cap, int64_t* first_ms,
                                int64_t* last_ms) {
  if (cap < 16 + 15 * n) return -1;
  int64_t pos = put_uvarint(out, 0, (uint64_t)n);
  int64_t prev_ts = 0, prev_delta = 0;
  uint32_t prev_bits = 0;
  for (int64_t i = 0; i < n; i++) {
    int64_t t = round_half_even_ll(head_ts[i] * 1000.0);
    if (i == 0) {
      *first_ms = t;
      pos = put_uvarint(out, pos, zigzag64(t));
    } else {
      int64_t delta = t - prev_ts;
      pos = put_uvarint(out, pos, zigzag64(delta - prev_delta));
      prev_delta = delta;
    }
    prev_ts = t;
    // Python reads the f32 cell as a double and packs it back to f32 —
    // an exact round trip for anything array('f') stores; mirror it so
    // the bit pattern below matches f32bits() exactly.
    float f = (float)(double)head_val[i];
    uint32_t bits;
    memcpy(&bits, &f, 4);
    pos = put_uvarint(out, pos, (uint64_t)(bits ^ prev_bits));
    prev_bits = bits;
  }
  *last_ms = prev_ts;
  if (n == 0) *first_ms = *last_ms = 0;
  return pos;
}

// Recording-rule store descriptor (tpumon_torch/query.py RuleStore): the
// data pointer + geometry packed into one struct so the per-tick call
// marshals a single pointer (ctypes argument conversion dominated a
// flat-argument spelling). Python caches one of these per store and
// rebuilds it when add_slot reallocates the arrays. `data` is
// ROW-MAJOR: one sub-bucket summary = 10 consecutive doubles
// [bucket-index (NaN = empty), n, sum, min, max, first_ts, first_v,
// last_ts, last_v, increase] — ~2 cache lines per matched series per
// tick, which is what makes the batched update memory-cheap at fleet
// series counts.
typedef struct {
  double sub;               // sub-bucket width (window / 16)
  int32_t nsub;             // closed-history rows per slot (ring size)
  int32_t map_len;          // length of slot_map
  const int32_t* slot_map;  // ring slot -> rule slot (-1 = unmatched)
  int32_t* hh;              // per rule slot: next hist-ring write pos
  double* open;             // ONE open row per slot (dense, hot)
  double* hist;             // nsub closed rows per slot (cold)
} TpumonRuleStore;

enum {
  RK_BIDX = 0, RK_N = 1, RK_SUM = 2, RK_MN = 3, RK_MX = 4,
  RK_FTS = 5, RK_FV = 6, RK_LTS = 7, RK_LV = 8, RK_INC = 9,
  RK_STRIDE = 10,
};

// Recording-rule accumulation: one shared-timestamp update of every
// matched series' OPEN sub-bucket row in ONE call per rule per tick.
// slots[] are the ring's global series slots for the tick's batch (the
// same array accum_many takes); st->slot_map translates them to rule
// slots (-1 = not matched, the overwhelmingly common case — one load +
// compare per series). The open rows are densely packed (80 B/series),
// so the steady-state working set is tiny and cache-resident; the cold
// hist ring is only touched on a bucket rollover (once per sub-bucket
// width). Mirrors RuleStore._observe_prebucketed bit-for-bit (same
// float adds in the same order). Returns the matched count.
int64_t tpumon_tsdb_rule_accum(int64_t n, double ts, const float* vals,
                               const int32_t* slots,
                               const TpumonRuleStore* st) {
  double b = py_floordiv(ts, st->sub);  // shared ts: one bucket for all
  int32_t nsub = st->nsub;
  int64_t matched = 0;
  for (int64_t i = 0; i < n; i++) {
    int32_t g = slots[i];
    if (g < 0 || g >= st->map_len) continue;
    int32_t r = st->slot_map[g];
    if (r < 0) continue;
    matched++;
    double v = (double)vals[i];  // f32 -> f64 exact; matches Python float
    double* row = st->open + (int64_t)r * RK_STRIDE;
    if (row[RK_BIDX] == b) {
      row[RK_N] += 1.0;
      row[RK_SUM] += v;
      if (v < row[RK_MN]) {
        row[RK_MN] = v;
      } else if (v > row[RK_MX]) {
        row[RK_MX] = v;
      }
      double d = v - row[RK_LV];
      row[RK_INC] += (d >= 0.0) ? d : v;
      row[RK_LTS] = ts;
      row[RK_LV] = v;
      continue;
    }
    if (row[RK_BIDX] == row[RK_BIDX]) {  // closed bucket: bank it
      int32_t h = st->hh[r];
      memcpy(st->hist + ((int64_t)r * nsub + h) * RK_STRIDE, row,
             RK_STRIDE * sizeof(double));
      st->hh[r] = (h + 1) % nsub;
    }
    row[RK_BIDX] = b;
    row[RK_N] = 1.0;
    row[RK_SUM] = v;
    row[RK_MN] = v;
    row[RK_MX] = v;
    row[RK_FTS] = ts;
    row[RK_LTS] = ts;
    row[RK_FV] = v;
    row[RK_LV] = v;
    row[RK_INC] = 0.0;
  }
  return matched;
}

// All registered rules in ONE call per tick: the ctypes FFI + pointer
// casts dominate a per-rule spelling (the C loops themselves are a few
// µs), so the per-tick entry point takes the whole rule list.
int64_t tpumon_tsdb_rule_accum_multi(int64_t n, double ts, const float* vals,
                                     const int32_t* slots,
                                     const TpumonRuleStore* const* stores,
                                     int32_t nstores) {
  int64_t matched = 0;
  for (int32_t s = 0; s < nstores; s++) {
    matched += tpumon_tsdb_rule_accum(n, ts, vals, slots, stores[s]);
  }
  return matched;
}

// Version tag so Python can detect ABI drift (independent of hostmon's).
int tpumon_tsdbkern_abi_version(void) { return 2; }

}  // extern "C"
