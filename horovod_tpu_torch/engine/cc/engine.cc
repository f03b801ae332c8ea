#include "engine.h"

#include <string.h>

#include <algorithm>
#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <limits>
#include <map>
#include <set>

#include "net.h"

namespace hvdtpu {

namespace {

// ---------------------------------------------------------------------------
// Dtype arithmetic helpers (reduction + half-precision staging).
// The reference delegated these to MPI_SUM / ncclSum; a TCP data plane has to
// do its own math.  f16/bf16 are staged through f32 (better numerics than
// reducing in half precision, and the MXU-friendly layout for any future
// on-device path).
// ---------------------------------------------------------------------------

template <typename T>
void AddInto(T* dst, const T* src, int64_t n) {
  for (int64_t i = 0; i < n; ++i) dst[i] += src[i];
}

void AccumulateSum(void* dst, const void* src, int64_t n, uint8_t dtype) {
  switch (dtype) {
    case HVD_UINT8:
      AddInto(static_cast<uint8_t*>(dst), static_cast<const uint8_t*>(src), n);
      break;
    case HVD_INT8:
      AddInto(static_cast<int8_t*>(dst), static_cast<const int8_t*>(src), n);
      break;
    case HVD_UINT16:
      AddInto(static_cast<uint16_t*>(dst), static_cast<const uint16_t*>(src),
              n);
      break;
    case HVD_INT32:
      AddInto(static_cast<int32_t*>(dst), static_cast<const int32_t*>(src), n);
      break;
    case HVD_INT64:
      AddInto(static_cast<int64_t*>(dst), static_cast<const int64_t*>(src), n);
      break;
    case HVD_FLOAT32:
      AddInto(static_cast<float*>(dst), static_cast<const float*>(src), n);
      break;
    case HVD_FLOAT64:
      AddInto(static_cast<double*>(dst), static_cast<const double*>(src), n);
      break;
    case HVD_BOOL: {
      // Sum on bool saturates to logical OR (what MPI_SUM on C bool gives).
      uint8_t* d = static_cast<uint8_t*>(dst);
      const uint8_t* s = static_cast<const uint8_t*>(src);
      for (int64_t i = 0; i < n; ++i) d[i] = (d[i] || s[i]) ? 1 : 0;
      break;
    }
    default:
      break;  // f16/bf16 never reach the wire: staged through f32
  }
}

template <typename T>
void DivideBy(T* dst, int64_t n, double divisor) {
  for (int64_t i = 0; i < n; ++i)
    dst[i] = static_cast<T>(dst[i] / divisor);
}

void DivideBuffer(void* buf, int64_t n, uint8_t dtype, double divisor) {
  switch (dtype) {
    case HVD_FLOAT32:
      DivideBy(static_cast<float*>(buf), n, divisor);
      break;
    case HVD_FLOAT64:
      DivideBy(static_cast<double*>(buf), n, divisor);
      break;
    case HVD_INT32:
      DivideBy(static_cast<int32_t*>(buf), n, divisor);
      break;
    case HVD_INT64:
      DivideBy(static_cast<int64_t*>(buf), n, divisor);
      break;
    case HVD_UINT8:
      DivideBy(static_cast<uint8_t*>(buf), n, divisor);
      break;
    case HVD_INT8:
      DivideBy(static_cast<int8_t*>(buf), n, divisor);
      break;
    case HVD_UINT16:
      DivideBy(static_cast<uint16_t*>(buf), n, divisor);
      break;
    default:
      break;  // bool: averaging is meaningless; result is the OR
  }
}

template <typename T>
void ScaleBy(T* dst, int64_t n, double scale) {
  for (int64_t i = 0; i < n; ++i) dst[i] = static_cast<T>(dst[i] * scale);
}

float HalfToFloat(uint16_t h) {
  uint32_t sign = (h & 0x8000u) << 16;
  uint32_t exp = (h >> 10) & 0x1f;
  uint32_t man = h & 0x3ffu;
  uint32_t bits;
  if (exp == 0) {
    if (man == 0) {
      bits = sign;
    } else {  // subnormal
      exp = 127 - 15 + 1;
      while (!(man & 0x400u)) {
        man <<= 1;
        --exp;
      }
      man &= 0x3ffu;
      bits = sign | (exp << 23) | (man << 13);
    }
  } else if (exp == 31) {
    bits = sign | 0x7f800000u | (man << 13);
  } else {
    bits = sign | ((exp + 127 - 15) << 23) | (man << 13);
  }
  float f;
  memcpy(&f, &bits, 4);
  return f;
}

uint16_t FloatToHalf(float f) {
  uint32_t bits;
  memcpy(&bits, &f, 4);
  uint16_t sign = static_cast<uint16_t>((bits >> 16) & 0x8000u);
  int32_t exp = static_cast<int32_t>((bits >> 23) & 0xff) - 127 + 15;
  uint32_t man = bits & 0x7fffffu;
  if (((bits >> 23) & 0xff) == 0xff) {  // inf/nan
    return sign | 0x7c00u | (man ? 0x200u : 0);
  }
  if (exp >= 31) return sign | 0x7c00u;  // overflow -> inf
  if (exp <= 0) {                        // subnormal / underflow
    if (exp < -10) return sign;
    man |= 0x800000u;
    int shift = 14 - exp;
    uint32_t half_man = man >> shift;
    uint32_t rem = man & ((1u << shift) - 1);
    uint32_t halfway = 1u << (shift - 1);
    if (rem > halfway || (rem == halfway && (half_man & 1))) ++half_man;
    return static_cast<uint16_t>(sign | half_man);
  }
  uint32_t half_man = man >> 13;
  uint32_t rem = man & 0x1fffu;
  if (rem > 0x1000u || (rem == 0x1000u && (half_man & 1))) {
    ++half_man;
    if (half_man == 0x400u) {
      half_man = 0;
      ++exp;
      if (exp >= 31) return sign | 0x7c00u;
    }
  }
  return static_cast<uint16_t>(sign | (exp << 10) | half_man);
}

float Bf16ToFloat(uint16_t b) {
  uint32_t bits = static_cast<uint32_t>(b) << 16;
  float f;
  memcpy(&f, &bits, 4);
  return f;
}

uint16_t FloatToBf16(float f) {
  uint32_t bits;
  memcpy(&bits, &f, 4);
  if ((bits & 0x7f800000u) == 0x7f800000u && (bits & 0x7fffffu))
    return static_cast<uint16_t>((bits >> 16) | 0x40);  // quiet nan
  uint32_t rounded = bits + 0x7fffu + ((bits >> 16) & 1);
  return static_cast<uint16_t>(rounded >> 16);
}

// ---------------------------------------------------------------------------
// fp8-e4m3fn (4 exponent bits, bias 7, 3 mantissa bits; no inf, 0x7f/0xff
// = nan) — the ml_dtypes.float8_e4m3fn layout the XLA plane mirrors with
// jnp casts.  Encoding SATURATES at ±448 instead of producing nan (the
// gradient-compression convention: one clipped outlier must not poison a
// whole fused bucket); the Python plane clips before casting for the same
// reason, so both planes quantize identically.
// ---------------------------------------------------------------------------

constexpr float kFp8Max = 448.0f;

uint8_t FloatToFp8(float f) {
  // Branchy bit-twiddled round-to-nearest-even (the hot loop of the fp8
  // wire path runs this per element; the frexp/nearbyint formulation it
  // replaced was 5x slower end to end).
  uint32_t bits;
  memcpy(&bits, &f, 4);
  uint8_t sign = static_cast<uint8_t>((bits >> 24) & 0x80u);
  uint32_t a = bits & 0x7fffffffu;
  if (a > 0x7f800000u) return sign | 0x7f;   // nan
  if (a >= 0x43e00000u) return sign | 0x7e;  // >= 448: saturate (no inf)
  if (a < 0x3c800000u) {
    // < 2^-6: subnormal grid, quantum 2^-9.  lrintf under the default
    // FE_TONEAREST mode is round-to-nearest-even, matching ml_dtypes;
    // a result of 8 lands exactly on the smallest normal (0x08).
    float av;
    memcpy(&av, &a, 4);
    return sign | static_cast<uint8_t>(lrintf(av * 512.0f));
  }
  // Normal: RNE the 23-bit mantissa down to 3 bits in the integer
  // domain, then rebias the exponent (127 -> 7).  Mantissa carry-out
  // propagates into the exponent arithmetically; a carry past 448
  // saturates.
  uint32_t rounded = a + 0x7ffffu + ((a >> 20) & 1u);
  if (rounded >= 0x43e00000u) return sign | 0x7e;
  uint32_t exp8 = ((rounded >> 23) & 0xffu) - 120u;
  return sign | static_cast<uint8_t>((exp8 << 3) | ((rounded >> 20) & 7u));
}

float Fp8ToFloat(uint8_t b) {
  static const std::vector<float> table = [] {
    std::vector<float> t(256);
    for (int i = 0; i < 256; ++i) {
      int exp = (i >> 3) & 0xf;
      int man = i & 7;
      float v;
      if (exp == 15 && man == 7)
        v = std::numeric_limits<float>::quiet_NaN();
      else if (exp == 0)
        v = std::ldexp(static_cast<float>(man), -9);
      else
        v = std::ldexp(1.0f + man / 8.0f, exp - 7);
      t[i] = (i & 0x80) ? -v : v;
    }
    return t;
  }();
  return table[b];
}

// ---------------------------------------------------------------------------
// Wire formats for the compressed ring (docs/performance.md
// #wire-compression): the reduction buffer stays f32 end to end, these
// helpers narrow segments at the send boundary and widen them back at the
// receive boundary.  COMP_* codes double as wire codes for f32 payloads;
// WIRE_F16 serves native-width f16 payload shipping.
// ---------------------------------------------------------------------------

constexpr uint8_t WIRE_BF16 = COMP_BF16;
constexpr uint8_t WIRE_FP8 = COMP_FP8;
constexpr uint8_t WIRE_F16 = 3;

size_t WireFormatSize(uint8_t wire) { return wire == WIRE_FP8 ? 1 : 2; }

void CompressBuf(const float* src, void* dst, int64_t n, uint8_t wire) {
  if (wire == WIRE_FP8) {
    uint8_t* d = static_cast<uint8_t*>(dst);
    for (int64_t i = 0; i < n; ++i) d[i] = FloatToFp8(src[i]);
  } else {
    uint16_t* d = static_cast<uint16_t*>(dst);
    if (wire == WIRE_F16)
      for (int64_t i = 0; i < n; ++i) d[i] = FloatToHalf(src[i]);
    else
      for (int64_t i = 0; i < n; ++i) d[i] = FloatToBf16(src[i]);
  }
}

void DecompressBuf(const void* src, float* dst, int64_t n, uint8_t wire) {
  if (wire == WIRE_FP8) {
    const uint8_t* s = static_cast<const uint8_t*>(src);
    for (int64_t i = 0; i < n; ++i) dst[i] = Fp8ToFloat(s[i]);
  } else {
    const uint16_t* s = static_cast<const uint16_t*>(src);
    if (wire == WIRE_F16)
      for (int64_t i = 0; i < n; ++i) dst[i] = HalfToFloat(s[i]);
    else
      for (int64_t i = 0; i < n; ++i) dst[i] = Bf16ToFloat(s[i]);
  }
}

void DecompressAccumulate(const void* src, float* dst, int64_t n,
                          uint8_t wire) {
  if (wire == WIRE_FP8) {
    const uint8_t* s = static_cast<const uint8_t*>(src);
    for (int64_t i = 0; i < n; ++i) dst[i] += Fp8ToFloat(s[i]);
  } else {
    const uint16_t* s = static_cast<const uint16_t*>(src);
    if (wire == WIRE_F16)
      for (int64_t i = 0; i < n; ++i) dst[i] += HalfToFloat(s[i]);
    else
      for (int64_t i = 0; i < n; ++i) dst[i] += Bf16ToFloat(s[i]);
  }
}

// One value's quantize -> dequantize round trip: what the wire will
// deliver, and therefore what the error-feedback residual is measured
// against.
float QuantDequant(float v, uint8_t wire) {
  if (wire == WIRE_FP8) {
    if (v > kFp8Max) v = kFp8Max;
    if (v < -kFp8Max) v = -kFp8Max;
    return Fp8ToFloat(FloatToFp8(v));
  }
  if (wire == WIRE_F16) return HalfToFloat(FloatToHalf(v));
  return Bf16ToFloat(FloatToBf16(v));
}

void HalfBufToFloat(const void* src, float* dst, int64_t n, uint8_t dtype) {
  const uint16_t* s = static_cast<const uint16_t*>(src);
  if (dtype == HVD_FLOAT16)
    for (int64_t i = 0; i < n; ++i) dst[i] = HalfToFloat(s[i]);
  else
    for (int64_t i = 0; i < n; ++i) dst[i] = Bf16ToFloat(s[i]);
}

void FloatBufToHalf(const float* src, void* dst, int64_t n, uint8_t dtype) {
  uint16_t* d = static_cast<uint16_t*>(dst);
  if (dtype == HVD_FLOAT16)
    for (int64_t i = 0; i < n; ++i) d[i] = FloatToHalf(src[i]);
  else
    for (int64_t i = 0; i < n; ++i) d[i] = FloatToBf16(src[i]);
}

int64_t NumElements(const std::vector<int64_t>& dims) {
  int64_t n = 1;
  for (int64_t d : dims) n *= d;
  return n;
}

std::string DimsToString(const std::vector<int64_t>& dims) {
  std::string s = "[";
  for (size_t i = 0; i < dims.size(); ++i) {
    if (i) s += ", ";
    s += std::to_string(dims[i]);
  }
  return s + "]";
}

// Fusion predicate shared by fresh negotiations (CoordinatorTick) and
// cached replays (ProcessCacheHits): may `bytes` more of `dtype` merge
// into the current allreduce `group`?  Both paths MUST stay equivalent,
// or replayed steps would get different ring-pass bucket boundaries than
// their first negotiation.
bool FusesInto(const Response& group, int64_t group_bytes,
               uint8_t group_dtype, uint8_t dtype, int64_t bytes,
               int64_t threshold) {
  // Stage-scoped buckets never fuse (docs/pipeline.md): a group op's
  // participant set differs from its neighbours', so a merged bucket
  // would have no single execution membership.  Both callers also check
  // the CANDIDATE's stage_ranks before offering it here.
  return group.type == RESP_ALLREDUCE && group.stage_ranks.empty() &&
         group.names.size() < 1024 && group_dtype == dtype &&
         group_bytes + bytes <= threshold;
}

// Participant count a pending negotiation must reach before its response
// builds: the pair for send/recv, the stage group's membership for a
// stage-scoped collective, the full world otherwise (docs/pipeline.md).
int RequiredCount(const Request& req, int world) {
  if (req.op == OP_SEND || req.op == OP_RECV) return 2;
  if (!req.stage_ranks.empty())
    return static_cast<int>(req.stage_ranks.size());
  return world;
}

// Ranks expected to announce a pending negotiation — the denominator the
// stall / timeout sweeps measure "missing" against.  For a p2p pair the
// expected set is the announcer(s) plus the peer each one named; for a
// stage group, its members; otherwise everyone.
std::vector<bool> ExpectedRanks(const std::vector<Request>& reqs,
                                int world) {
  std::vector<bool> expected(world, false);
  if (reqs.empty() ||
      (reqs[0].op != OP_SEND && reqs[0].op != OP_RECV &&
       reqs[0].stage_ranks.empty())) {
    expected.assign(world, true);
    return expected;
  }
  if (!reqs[0].stage_ranks.empty()) {
    for (int32_t m : reqs[0].stage_ranks)
      if (m >= 0 && m < world) expected[m] = true;
    return expected;
  }
  for (const auto& r : reqs) {
    if (r.rank >= 0 && r.rank < world) expected[r.rank] = true;
    if (r.p2p_peer >= 0 && r.p2p_peer < world) expected[r.p2p_peer] = true;
  }
  return expected;
}

// Expected announcers of a cached slot's agreement (the cache_pending
// analogue of ExpectedRanks): the stored pair for p2p, the stage members
// for a group op, everyone otherwise.
std::vector<bool> SlotExpectedRanks(const CacheSlot* s, int world) {
  std::vector<bool> expected(world, true);
  if (s == nullptr) return expected;
  if (s->response.type == RESP_SENDRECV) {
    expected.assign(world, false);
    if (s->response.p2p_src >= 0 && s->response.p2p_src < world)
      expected[s->response.p2p_src] = true;
    if (s->response.p2p_dst >= 0 && s->response.p2p_dst < world)
      expected[s->response.p2p_dst] = true;
  } else if (!s->response.stage_ranks.empty()) {
    expected.assign(world, false);
    for (int32_t m : s->response.stage_ranks)
      if (m >= 0 && m < world) expected[m] = true;
  }
  return expected;
}

// "1, 3" for the ranks NOT marked in `present`.
std::string MissingRanks(const std::vector<bool>& present) {
  std::string missing;
  for (size_t r = 0; r < present.size(); ++r)
    if (!present[r])
      missing += (missing.empty() ? "" : ", ") + std::to_string(r);
  return missing;
}

}  // namespace

// ---------------------------------------------------------------------------
// Negotiation response cache (docs/performance.md).  All mutation happens
// on the engine thread while processing the broadcast response lists, in
// list order, so every rank's cache evolves in lockstep — the property
// that lets a bare slot index stand in for a full string request.
// ---------------------------------------------------------------------------

int ResponseCache::Lookup(const Request& req) const {
  auto it = by_name_.find(req.name);
  if (it == by_name_.end()) return -1;
  const CacheSlot& s = slots_[it->second];
  // Point-to-point slots are stored from the broadcast response's
  // metadata (identical on every rank, participant or not), so the
  // signature match is role-aware: this rank's request matches when it
  // restates the same pair orientation the agreement recorded.
  if (s.response.type == RESP_SENDRECV) {
    const Response& a = s.response;
    bool as_send = req.op == OP_SEND && req.rank == a.p2p_src &&
                   req.p2p_peer == a.p2p_dst;
    bool as_recv = req.op == OP_RECV && req.rank == a.p2p_dst &&
                   req.p2p_peer == a.p2p_src;
    if (!(as_send || as_recv) || req.p2p_tag != a.p2p_tag ||
        req.dtype != a.p2p_dtype || req.dims != a.p2p_dims)
      return -1;
    return it->second;
  }
  if (s.op != req.op || s.dtype != req.dtype ||
      s.root_rank != req.root_rank || s.dims != req.dims ||
      req.stage_ranks != s.response.stage_ranks)
    return -1;
  return it->second;
}

int ResponseCache::SlotByName(const std::string& name) const {
  auto it = by_name_.find(name);
  return it == by_name_.end() ? -1 : it->second;
}

const CacheSlot* ResponseCache::Get(int slot) const {
  if (slot < 0 || slot >= static_cast<int>(slots_.size()) ||
      !slots_[slot].valid)
    return nullptr;
  return &slots_[slot];
}

int ResponseCache::Put(const std::string& name, uint8_t op, uint8_t dtype,
                       const std::vector<int64_t>& dims, int32_t root_rank,
                       const Response& response, CacheSlot* evicted) {
  evicted->valid = false;
  auto it = by_name_.find(name);
  int slot;
  if (it != by_name_.end()) {
    slot = it->second;
  } else if (static_cast<int64_t>(by_name_.size()) < capacity_) {
    // Lowest free slot (deterministic: slot states evolve in lockstep).
    slot = -1;
    for (int i = 0; i < static_cast<int>(slots_.size()); ++i)
      if (!slots_[i].valid) {
        slot = i;
        break;
      }
    if (slot < 0) {
      slot = static_cast<int>(slots_.size());
      slots_.emplace_back();
    }
  } else {
    // Full: evict the least-recently-touched entry.  The linear scan only
    // runs on fresh-name inserts past capacity — steady state is pure
    // hits, which never reach here.
    slot = 0;
    for (int i = 1; i < static_cast<int>(slots_.size()); ++i)
      if (slots_[i].valid &&
          (!slots_[slot].valid ||
           slots_[i].last_touch < slots_[slot].last_touch))
        slot = i;
    *evicted = slots_[slot];
    by_name_.erase(slots_[slot].name);
  }
  CacheSlot& s = slots_[slot];
  s.valid = true;
  s.last_touch = ++touch_counter_;
  s.name = name;
  s.op = op;
  s.dtype = dtype;
  s.root_rank = root_rank;
  s.dims = dims;
  s.response = response;
  by_name_[name] = slot;
  return slot;
}

void ResponseCache::Touch(int slot) {
  if (slot >= 0 && slot < static_cast<int>(slots_.size()) &&
      slots_[slot].valid)
    slots_[slot].last_touch = ++touch_counter_;
}

void ResponseCache::Erase(const std::string& name) {
  auto it = by_name_.find(name);
  if (it == by_name_.end()) return;
  slots_[it->second] = CacheSlot();
  by_name_.erase(it);
}

void ResponseCache::Clear() {
  slots_.clear();
  by_name_.clear();
  // touch_counter_ keeps rolling: only relative order matters.
}

// ---------------------------------------------------------------------------
// Coordinator state (rank 0).  Analogue of the reference MessageTable +
// IncrementTensorCount/ConstructMPIResponse
// (Horovod's horovod/common/operations.cc:101,268,301).
// ---------------------------------------------------------------------------

struct Engine::Coordinator {
  struct PendingTensor {
    std::vector<Request> requests;  // one per rank that announced, any order
    std::chrono::steady_clock::time_point first_seen;
    uint64_t order = 0;
    // Announce-time accounting on rank 0's clock (µs since epoch): under
    // the coordinator tree the sub-coordinators forward each rank's TRUE
    // announce timestamp in the aggregate frame, so the last-to-announce
    // straggler verdict names the rank that was actually late, not the
    // sub-coordinator whose aggregate closed the count.
    int64_t first_us = -1;
    int64_t last_us = -1;
    int last_rank = -1;
    // Set when a cross-transport mismatch is detected (one camp announced
    // the bare name over the engine, another the "__xp."-prefixed
    // metadata op for the SAME logical tensor over the XLA plane): the
    // name negotiates straight to a typed error response instead of
    // stalling forever at count < size.
    std::string forced_error;
    // Entries for a recently-poisoned base name get a decision deadline
    // instead of an immediate error: if all ranks announce (a corrected,
    // consistent resubmission) the name negotiates normally and the
    // poison clears; if the count still stalls at the deadline, the
    // announcers are stragglers of the mismatched round and get the
    // poison's typed error.  0 = no deadline.
    int64_t poison_deadline_tick = 0;
  };
  std::unordered_map<std::string, PendingTensor> message_table;
  std::vector<std::string> ready;  // names with all ranks announced, in order
  // Base names that hit a cross-transport mismatch: stragglers of either
  // camp announcing within the poison window after the error response was
  // broadcast re-trigger the same typed error instead of re-pending
  // forever.  Entries EXPIRE (kPoisonWindowSec) so a later, consistent
  // resubmission of the same tensor name works again — the recovery
  // contract docs/tpu.md promises.  Bounded: cleared past 1024 entries.
  static constexpr double kPoisonWindowSec = 5.0;
  static constexpr int64_t kPoisonDeadlineTicks = 40;  // ~200ms @ 5ms cycle
  // A straggler first announcing AFTER the window expired still must not
  // pend forever (its peers consumed their error responses long ago).
  // The expired tombstone grants a stall-warning-length grace deadline:
  // any healthy (if skewed) full-count reuse of the name negotiates
  // normally well within it, and a still-short count at the deadline —
  // the point where the stall sweep would start warning anyway — gets
  // the typed error instead of an indefinite pend.
  std::unordered_map<std::string,
                     std::pair<std::string,
                               std::chrono::steady_clock::time_point>>
      poisoned;
  uint64_t next_order = 0;
  bool shutdown_requested = false;
  // Response-cache intersection: per-slot bit announcements still short of
  // full count (the integer-keyed analogue of message_table — no strings,
  // no per-tensor Request rebuild on the steady-state path).
  struct PendingBits {
    std::vector<bool> ranks;
    int count = 0;
    std::chrono::steady_clock::time_point first_seen;
    // Same per-rank announce-time accounting as PendingTensor.
    int64_t first_us = -1;
    int64_t last_us = -1;
    int last_rank = -1;
  };
  std::unordered_map<uint32_t, PendingBits> cache_pending;
  // Slots every rank announced, in agreement order; broadcast as
  // ResponseList.cache_hits next tick.
  std::vector<uint32_t> cached_ready;
  // Liveness (rank 0): workers whose control socket hit EOF/error.  The
  // first death arms the coordinated abort below; later deaths are noted
  // but the first abort wins.
  std::vector<bool> rank_dead;
  // Postmortem accounting (per rank, engine thread only): the tick each
  // rank's last control frame arrived at, and the tick/name of its last
  // collective announce — the raw material of the cross-rank diagnosis
  // ("rank 2 stopped announcing after tick 1841").  -1 = never.
  std::vector<int64_t> last_frame_tick;
  std::vector<int64_t> last_announce_tick;
  std::vector<std::string> last_announce_name;
  // Armed abort, broadcast in the next response list: ST_RANKS_DOWN or
  // ST_TIMEOUT plus a structured message naming missing ranks / stalled
  // tensors.  0 = not aborting.
  int32_t abort_code = 0;
  std::string abort_message;
  // Elastic membership (docs/fault-tolerance.md#elastic-membership).
  // reshape_pending arms a SHRINK barrier at the next tick (a worker died
  // but >= min_size survive); pending joiners are standbys that connected
  // to the control listen socket and await admission at the next barrier.
  bool reshape_pending = false;
  std::vector<int> pending_join_fds;
  std::vector<std::string> pending_join_endpoints;
  // Accepted control-plane connects whose JOIN handshake bytes have not
  // arrived yet.  The handshake is completed only once the fd is
  // readable, so a connect that never sends anything (health probe, port
  // scanner) costs the negotiation tick nothing and is dropped at its
  // deadline instead of stalling every worker's response wait.
  struct Handshake {
    int fd;
    std::chrono::steady_clock::time_point deadline;
    std::vector<uint8_t> buf;  // handshake bytes assembled so far
  };
  std::vector<Handshake> handshaking;
  // When the FIRST currently-pending joiner registered: a grow barrier
  // prefers a quiesced tick, but a fully pipelined training loop may
  // never quiesce — past a bounded wait the barrier is forced (in-flight
  // collectives get the same retryable ST_RESHAPE a shrink hands out),
  // so standby admission cannot starve behind steady traffic.
  std::chrono::steady_clock::time_point join_wait_since;
  // Decentralized steady state (docs/performance.md
  // #control-plane-scaling): the pattern detector's recent cache-hit
  // slot stream, each entry flagged when it opened a new broadcast list
  // (the per-tick grouping replayed buckets must reproduce).  Reset by
  // any non-hit broadcast (fresh response, tuned params, reshape, abort)
  // so the window only ever contains a pure steady-state hit stream.
  std::deque<std::pair<uint32_t, bool>> slot_history;
  // A STEADY verdict is in force: the coordinator broadcasts nothing
  // (beyond abort/shutdown) until EVERY rank has fallen back — an
  // earlier broadcast would double-execute replays on ranks still
  // self-clocking.
  bool steady = false;
  std::vector<bool> steady_exited;
  // Stamp the first post-steady broadcast with the revoke marker.
  bool steady_revoke_next = false;
};

// Control-plane hello a standby sends instead of a rank number when
// rejoining a live elastic job (rank hellos are < size, so this cannot
// collide).
static const uint32_t kJoinHello = 0xFFFFFFFEu;

Engine* GlobalEngine() {
  // Intentionally leaked: outlives any Python teardown order, mirroring the
  // reference's never-destructed HorovodGlobalState.
  static Engine* engine = new Engine();
  return engine;
}

Engine::Engine() = default;

Engine::~Engine() { Shutdown(); }

int Engine::Init(const EngineOptions& opts, std::string* err) {
  if (initialized_.load()) return 0;
  opts_ = opts;
  if (opts_.hierarchical_allreduce && opts_.size == 1)
    opts_.hierarchical_allreduce = false;
  if (opts_.elastic && opts_.hierarchical_allreduce) {
    // Reshapes rebuild only the flat ring; the two-level topology's
    // node-local stars would go stale at the first membership change.
    fprintf(stderr,
            "[horovod_tpu] WARNING: elastic membership forces the flat "
            "ring (hierarchical allreduce disabled).\n");
    opts_.hierarchical_allreduce = false;
  }
  // The multi-rank layout validation (ranks in contiguous blocks of
  // local_size, the hvdrun layout — analogue of the reference's
  // MPI_Comm_split_type shared-memory split, operations.cc:1364-1373)
  // happens inside SetupSockets over the coordinator star, so that every
  // rank reaches the SAME hierarchical/flat decision before any data-plane
  // topology is built.
  shut_down_.store(false);
  loop_exited_.store(false);
  data_plane_failed_.store(false);
  completions_.store(0);
  ticks_done_.store(0);
  {
    // abort_events_ stays cumulative across re-init (metrics contract,
    // like stall_events_); the latched status resets with the engine.
    std::lock_guard<std::mutex> lk(abort_mu_);
    abort_code_.store(0);
    abort_message_.clear();
    abort_pending_info_.clear();
  }
  epoch_ = std::chrono::steady_clock::now();
  clock_offset_us_.store(0);
  clock_rtt_us_.store(0);
  {
    // Announce counts are process-cumulative (like stall_events_); only
    // grow the per-rank vector if this job is wider than the last.
    std::lock_guard<std::mutex> lk(announce_mu_);
    if (static_cast<int>(last_announce_counts_.size()) < opts_.size)
      last_announce_counts_.resize(opts_.size, 0);
  }
  coord_.reset(new Coordinator());
  coord_->rank_dead.assign(opts_.size, false);
  coord_->last_frame_tick.assign(opts_.size, -1);
  coord_->last_announce_tick.assign(opts_.size, -1);
  coord_->last_announce_name.assign(opts_.size, "");
  // Control-plane tree + steady state start each lifetime cold; the
  // entry/exit/replay/frame counters stay process-cumulative (the
  // metrics contract StallEvents set).
  tree_enabled_ = false;
  is_sub_coord_ = false;
  sub_holding_ = false;
  tree_child_fds_.clear();
  tree_child_ranks_.clear();
  tree_child_dead_.clear();
  coord_children_.clear();
  pending_dead_reports_.clear();
  steady_active_.store(false);
  steady_pattern_.clear();
  steady_groups_.clear();
  steady_pos_ = steady_group_idx_ = 0;
  steady_epoch_ = 0;
  steady_pending_group_.clear();
  steady_pending_reqs_.clear();
  steady_exit_pending_ = false;
  steady_pattern_len_.store(0);
  ctrl_children_.store(0);
  ctrl_hosts_.store(1);
  if (opts_.elastic || opts_.rejoin) {
    // Elastic jobs keep the one-level star: membership reshapes rebuild
    // only the star, never a tree.  Steady state STAYS available
    // (hvdmodel's reshape-mid-steady interleavings pinned the protocol):
    // a barrier arming mid-steady is broadcast as a revocation first —
    // self-clocking ranks poll their parent socket every pass and treat
    // any payload broadcast as a revocation — and the barrier then
    // fires on the next regular tick (MaybeRevokeSteadyForReshape).
    opts_.coord_tree = false;
  }
  {
    std::lock_guard<std::mutex> lk(coord_info_mu_);
    coord_pending_info_.clear();
  }
  // Flight recorder (postmortem plane): always-on unless sized to 0.
  // Env-read here rather than plumbed through the init signature — the
  // ring is pure observability and every rank reads the same launcher
  // environment.
  {
    const char* cap_env = getenv("HVD_TPU_FLIGHT_EVENTS");
    int64_t cap = 512;
    if (cap_env && *cap_env) cap = atoll(cap_env);
    if (cap < 0) cap = 0;
    flight_.Initialize(cap, epoch_);
  }
  // Data-plane heartbeat detector + link-fault injection
  // (docs/fault-tolerance.md#failure-detection).  Env-read here like the
  // flight recorder: every rank reads the same launcher environment, and
  // the knobs must be known BEFORE SetupSockets (which dials the beat
  // sockets only when the detector is on).
  {
    const char* hb_env = getenv("HVD_TPU_HEARTBEAT_MS");
    hb_interval_ms_ = (hb_env && *hb_env) ? atoi(hb_env) : 100;
    if (hb_interval_ms_ < 0) hb_interval_ms_ = 0;
    const char* miss_env = getenv("HVD_TPU_HEARTBEAT_MISS");
    hb_miss_limit_ = (miss_env && *miss_env) ? atoi(miss_env) : 10;
    if (hb_miss_limit_ < 1) hb_miss_limit_ = 1;
    const char* fault_env = getenv("HVD_TPU_NET_FAULT_SPEC");
    std::string fault_err;
    if (!NetFaultInit(fault_env ? fault_env : "", opts_.rank, &fault_err)) {
      *err = "bad HVD_TPU_NET_FAULT_SPEC: " + fault_err;
      return 1;
    }
    // Perf-introspection plane (docs/metrics.md#links / #anomalies):
    // per-link telemetry default-on (counters are process-cumulative and
    // cost one mutex hold per transport call; HVD_TPU_LINK_STATS=0 is
    // the kill switch), anomaly detector default sigma 5 (0 disables).
    const char* ls_env = getenv("HVD_TPU_LINK_STATS");
    NetLinkInit(!(ls_env && *ls_env && atoi(ls_env) == 0));
    const char* as_env = getenv("HVD_TPU_ANOMALY_SIGMA");
    anomaly_sigma_ = (as_env && *as_env) ? atoi(as_env) : 5;
    if (anomaly_sigma_ < 0) anomaly_sigma_ = 0;
    const char* ai_env = getenv("HVD_TPU_ANOMALY_INTERVAL_MS");
    anomaly_interval_ms_ = (ai_env && *ai_env) ? atoi(ai_env) : 500;
    if (anomaly_interval_ms_ < 10) anomaly_interval_ms_ = 10;
    anomaly_stop_.store(false);
    // Transport seam policy (docs/performance.md#transport).  Env-read
    // here like the knobs above, but the MODE becomes part of the init
    // job-wide agreement in SetupSockets — a per-rank divergence (one
    // rank with the kill switch thrown) would otherwise split the job
    // between transports mid-ring.
    shm_mode_ = ParseShmMode(getenv("HVD_TPU_SHM"));
    const char* srb_env = getenv("HVD_TPU_SHM_RING_BYTES");
    shm_ring_bytes_ = (srb_env && *srb_env) ? atoll(srb_env) : (1 << 20);
    if (shm_ring_bytes_ < (64 << 10)) shm_ring_bytes_ = 64 << 10;
    shm_agreed_ = false;
    shm_active_ = false;
    topo_shm_.store(false);
    std::lock_guard<std::mutex> lk(hb_mu_);
    hb_last_seen_us_.clear();
    hb_miss_counts_.clear();
    pending_hb_dead_.clear();
    pending_hb_report_.clear();
    hb_wake_fds_.clear();
    hb_ctrl_wake_fd_ = -1;
    hb_epoch_ = 0;
    hb_local_abort_msg_.clear();
    hb_local_abort_.store(false);
    hb_stop_.store(false);
  }
  fast_ticks_ = 0;
  last_fusion_use_ = epoch_;
  // Every rank writes its own trace; the Python side resolves
  // HOROVOD_TIMELINE's directory / %d forms to a per-rank path (a plain
  // file path stays rank-0-only there, for the legacy single-file mode).
  timeline_.Initialize(opts_.timeline_path, opts_.rank, epoch_);
  // Elastic membership starts each lifetime at epoch 0.  The lost/joined
  // lists and reshapes_total_ stay PROCESS-CUMULATIVE (like
  // stall_events_): their lengths back the hvd_tpu_membership_*_total
  // Prometheus counters, which must never decrease across an in-process
  // re-init.  Only the poison message is per-lifetime.
  membership_epoch_.store(0);
  reshape_ack_pending_.store(false);
  {
    std::lock_guard<std::mutex> lk(membership_mu_);
    reshape_message_.clear();
  }
  std::string setup_err;
  bool setup_ok = opts_.rejoin ? SetupRejoinSockets(&setup_err)
                               : SetupSockets(&setup_err);
  if (!setup_ok) {
    *err = setup_err;
    TeardownSockets();
    return 1;
  }
  // rank/size may have been (re)assigned by the rejoin admission; the
  // atomics below are what Python's hvd.rank()/hvd.size() read.
  cur_rank_.store(opts_.rank);
  cur_size_.store(opts_.size);
  cur_local_rank_.store(opts_.local_rank);
  cur_local_size_.store(opts_.local_size);
  timeline_.WriteClockSync(clock_offset_us_.load(), clock_rtt_us_.load());
  // The response cache starts cold every engine lifetime: restart epochs
  // and in-process re-inits must renegotiate (the peers' caches are
  // gone).  Hit/miss/eviction counters stay process-cumulative, like
  // stalls.  The capacity is the JOB-WIDE agreement SetupSockets just
  // negotiated — per-rank env divergence (one rank with the kill switch
  // thrown, or a smaller HVD_TPU_CACHE_CAPACITY) would otherwise make a
  // slot index mean different things on different ranks.
  cache_.set_capacity(opts_.cache_capacity);
  cache_.Clear();
  cache_size_.store(0);
  // Wire compression (docs/performance.md#wire-compression): per-engine-
  // lifetime state.  SetupSockets just validated the mode/min-bytes
  // agreement job-wide; residuals start empty (a restart epoch must not
  // replay stale error feedback), and the decision log restarts so the
  // lockstep-identical contract is testable per lifetime.
  cur_compression_.store(opts_.compression_mode);
  cur_comp_min_bytes_.store(opts_.compression_min_bytes);
  residuals_.clear();
  residual_bytes_.store(0);
  residual_tensors_.store(0);
  {
    std::lock_guard<std::mutex> lk(comp_mu_);
    comp_log_.clear();
  }
  if (opts_.compression_mode != COMP_NONE && flight_.Enabled())
    flight_.Record(FL_COMPRESS, "", opts_.compression_mode);
  // Online autotuning (docs/performance.md#autotuning): the search runs
  // at the coordinator only; every rank tracks the applied parameters.
  // State is per-engine-lifetime — a restart epoch re-tunes from its env
  // (the winning params are in the previous run's report for pinning).
  // The compression axis is searchable only when the job opted into a
  // lossy wire format: with HVD_TPU_COMPRESSION off the axis pins at
  // "none" so the tuner can never silently make an exact job lossy.
  // (The two-level topology no longer pins it: the DCN hop compresses
  // like the flat ring.)  The cross-algo axis is the dual: it only means
  // anything on the two-level topology, so a flat-ring job pins it at
  // the env value instead of burning windows scoring a dead knob.
  // Both topology-coupled axes go dead on a single-NODE two-level job
  // (no DCN hop): pin them rather than burn windows scoring identical
  // points.  n_nodes_ is known here — SetupSockets already ran.
  bool cross_hop_live = opts_.hierarchical_allreduce && n_nodes_ > 1;
  int64_t tuner_fix_comp = opts_.compression_mode == COMP_NONE
                               ? COMP_NONE
                               : opts_.autotune_fix_compression;
  if (opts_.hierarchical_allreduce && !cross_hop_live)
    tuner_fix_comp = opts_.compression_mode;
  tuner_.Configure(opts_.autotune && (opts_.rank == 0 || opts_.size == 1),
                   opts_.autotune_warmup, opts_.autotune_window,
                   opts_.autotune_fix_fusion, opts_.autotune_fix_cycle_ms,
                   tuner_fix_comp,
                   cross_hop_live ? opts_.autotune_fix_cross_algo
                                  : opts_.cross_algo_threshold,
                   opts_.fusion_threshold, opts_.cycle_time_ms,
                   opts_.compression_mode, opts_.cross_algo_threshold);
  cur_fusion_.store(opts_.fusion_threshold);
  cur_cycle_us_.store(static_cast<int64_t>(opts_.cycle_time_ms * 1000.0));
  cur_cross_algo_.store(opts_.cross_algo_threshold);
  topo_last_algo_.store(-1);
  autotune_frozen_.store(false);
  applied_window_.store(0);
  {
    std::lock_guard<std::mutex> lk(autotune_mu_);
    applied_log_.clear();
    fusion_history_.clear();
    fusion_history_.emplace_back(0, opts_.fusion_threshold);
    compression_history_.clear();
    compression_history_.emplace_back(0, opts_.compression_mode);
  }
  last_stall_check_ = std::chrono::steady_clock::now();
  initialized_.store(true);
  background_ = std::thread([this]() { BackgroundLoop(); });
  // Liveness monitor: off the engine tick by construction, so a busy (or
  // blocked) local ring never starves the beats.  An elastic solo rank
  // starts it too — the first grow's RebuildRing hands it beat sockets.
  if (hb_interval_ms_ > 0 && (opts_.size > 1 || opts_.elastic))
    hb_thread_ = std::thread([this]() { HeartbeatLoop(); });
  // Anomaly detector: same off-the-tick construction.  Single-rank jobs
  // skip it (no links, no announce order, nothing to localize).
  if (anomaly_sigma_ > 0 && opts_.size > 1)
    anomaly_thread_ = std::thread([this]() { AnomalyLoop(); });
  return 0;
}

bool Engine::SetupSockets(std::string* err) {
  if (opts_.size == 1) {
    // A solo ELASTIC coordinator still needs its listen sockets: the
    // control listener is where standbys register (a job launched at or
    // shrunk to one rank must keep accepting joiners) and the data
    // listener is what RebuildRing accepts the first grow's neighbour
    // on.  Endpoints come from the launcher env; a plain single-process
    // init without them simply stays non-growable.
    if (opts_.elastic && !opts_.coord_endpoint.empty() &&
        !opts_.data_endpoints.empty()) {
      std::string host;
      int port;
      if (ParseEndpoint(opts_.coord_endpoint, &host, &port))
        coord_listen_fd_ = Listen("0.0.0.0", port, err);
      if (coord_listen_fd_ >= 0 &&
          ParseEndpoint(opts_.data_endpoints[0], &host, &port))
        data_listen_fd_ = Listen("0.0.0.0", port, err);
      if (coord_listen_fd_ < 0 || data_listen_fd_ < 0) {
        *err = "elastic single-rank listen failed: " + *err;
        return false;
      }
      coord_fds_.assign(1, -1);
    }
    return true;
  }
  std::string host;
  int port;
  const double kTimeout = 120.0;
  // Control plane: rank-0 star.
  if (opts_.rank == 0) {
    if (!ParseEndpoint(opts_.coord_endpoint, &host, &port)) {
      *err = "bad coordinator endpoint " + opts_.coord_endpoint;
      return false;
    }
    coord_listen_fd_ = Listen("0.0.0.0", port, err);
    if (coord_listen_fd_ < 0) return false;
  }
  // Data plane: every rank listens on its endpoint.
  if (!ParseEndpoint(opts_.data_endpoints[opts_.rank], &host, &port)) {
    *err = "bad data endpoint " + opts_.data_endpoints[opts_.rank];
    return false;
  }
  data_listen_fd_ = Listen("0.0.0.0", port, err);
  if (data_listen_fd_ < 0) return false;

  if (opts_.rank == 0) {
    coord_fds_.assign(opts_.size, -1);
    for (int pending = opts_.size - 1; pending > 0;) {
      int fd = AcceptOne(coord_listen_fd_, kTimeout, err);
      if (fd < 0) return false;
      uint32_t peer_rank;
      if (!RecvAll(fd, &peer_rank, 4)) {
        *err = "bad hello from worker";
        CloseFd(fd);
        return false;
      }
      if (opts_.elastic && peer_rank == kJoinHello) {
        // A standby can register while init is still collecting worker
        // hellos: hvdrun backfills toward --max-np from the first tick of
        // the keep-alive loop, so a start-small launch (-np 2 --max-np 6)
        // races its first standby against this loop.  Park it for the
        // first reshape barrier instead of failing the whole job's init.
        if (!RegisterJoiner(fd, 1.0)) CloseFd(fd);
        continue;
      }
      if (peer_rank >= (uint32_t)opts_.size || coord_fds_[peer_rank] >= 0) {
        *err = "bad hello from worker";
        CloseFd(fd);
        return false;
      }
      coord_fds_[peer_rank] = fd;
      --pending;
    }
  } else {
    if (!ParseEndpoint(opts_.coord_endpoint, &host, &port)) {
      *err = "bad coordinator endpoint " + opts_.coord_endpoint;
      return false;
    }
    coord_fd_ = ConnectRetry(host, port, kTimeout, err);
    if (coord_fd_ < 0) return false;
    uint32_t my_rank = static_cast<uint32_t>(opts_.rank);
    if (!SendAll(coord_fd_, &my_rank, 4)) {
      *err = "hello send failed";
      return false;
    }
  }
  // Topology agreement: every rank reports (local_rank, local_size,
  // hierarchical-requested) to rank 0, which validates the contiguous-block
  // layout globally and broadcasts one job-wide hierarchical/flat decision.
  // A per-rank decision could diverge (e.g. interleaved placement passing
  // the modular check on some ranks only) and deadlock the socket setup.
  {
    // The 4th slot agrees on the response-cache capacity job-wide (the
    // minimum across ranks — a thrown kill switch anywhere disables it
    // everywhere): per-rank divergence would make a cache-slot index
    // mean different collectives on different ranks.  Slots 5/6 carry
    // the wire-compression config, which must be IDENTICAL on every rank
    // — a min-reduce would silently weaken a rank's explicit choice, and
    // a split would make ranks pack the same bucket in different wire
    // formats; a mismatch is therefore a typed init error, not a vote.
    uint32_t cap32 = static_cast<uint32_t>(std::min<int64_t>(
        std::max<int64_t>(opts_.cache_capacity, 0), 0x7fffffff));
    uint32_t cmin32 = static_cast<uint32_t>(std::min<int64_t>(
        std::max<int64_t>(opts_.compression_min_bytes, 0), 0x7fffffff));
    // Slot 7 carries the HVD_TPU_SHM transport choice, with the same
    // IDENTICAL-everywhere contract as compression: a split would put
    // some ranks of a node ring on the segment and others on the socket,
    // which deadlocks the first local hop.  Like compression, mismatch
    // is a typed init error, never a vote.
    uint32_t mine[8] = {(uint32_t)opts_.local_rank, (uint32_t)opts_.local_size,
                        opts_.hierarchical_allreduce ? 1u : 0u, cap32,
                        (uint32_t)opts_.compression_mode, cmin32,
                        opts_.coord_tree ? 1u : 0u, (uint32_t)shm_mode_};
    // {hierarchical decision, capacity, compression mismatch flag,
    //  coordinator-tree decision, transport mismatch flag, shm verdict}
    uint32_t reply[6] = {0, cap32, 0, 0, 0, 0};
    if (opts_.rank == 0) {
      std::vector<uint32_t> lr(opts_.size), ls(opts_.size), hr(opts_.size);
      lr[0] = mine[0]; ls[0] = mine[1]; hr[0] = mine[2];
      bool tree_want = mine[6] != 0;
      uint32_t agreed_cap = cap32;
      std::string comp_mismatch;
      std::string shm_mismatch;
      for (int r = 1; r < opts_.size; ++r) {
        uint32_t peer[8];
        if (!RecvAll(coord_fds_[r], peer, sizeof peer)) {
          *err = "topology agreement recv failed";
          return false;
        }
        lr[r] = peer[0]; ls[r] = peer[1]; hr[r] = peer[2];
        tree_want = tree_want && peer[6] != 0;
        agreed_cap = std::min(agreed_cap, peer[3]);
        if (comp_mismatch.empty() &&
            (peer[4] != mine[4] || peer[5] != mine[5]))
          comp_mismatch =
              "HVD_TPU_COMPRESSION mismatch: rank 0 configured mode " +
              std::string(CompressionName(opts_.compression_mode)) +
              " (min bytes " + std::to_string(cmin32) + ") but rank " +
              std::to_string(r) + " configured mode " +
              CompressionName(static_cast<uint8_t>(peer[4])) +
              " (min bytes " + std::to_string(peer[5]) +
              "); wire compression must be configured identically on "
              "every rank.";
        if (shm_mismatch.empty() && peer[7] != mine[7])
          shm_mismatch =
              "HVD_TPU_SHM mismatch: rank 0 configured mode " +
              std::string(ShmModeName(shm_mode_)) + " but rank " +
              std::to_string(r) + " configured mode " +
              ShmModeName(static_cast<ShmMode>(peer[7] <= 2 ? peer[7] : 1)) +
              "; the data-plane transport must be configured identically "
              "on every rank.";
      }
      bool want = true, valid = true;
      for (int r = 0; r < opts_.size; ++r) want = want && hr[r] != 0;
      uint32_t L = ls[0];
      // L == 1 would make the leader ring an exact duplicate of the flat
      // global ring; fall back rather than double the data-plane sockets.
      if (L < 2 || opts_.size % (int)L != 0) valid = false;
      for (int r = 0; valid && r < opts_.size; ++r)
        if (ls[r] != L || lr[r] != (uint32_t)(r % (int)L)) valid = false;
      if (want && !valid && L >= 2)
        fprintf(stderr,
                "[horovod_tpu] WARNING: hierarchical allreduce requires "
                "equal local_size on every rank and ranks grouped in "
                "contiguous blocks of local_size; falling back to the flat "
                "ring.\n");
      reply[0] = (want && valid) ? 1 : 0;
      reply[1] = agreed_cap;
      reply[2] = comp_mismatch.empty() ? 0 : 1;
      // Coordinator-tree verdict (docs/performance.md
      // #control-plane-scaling): same contiguous-block layout contract
      // as the data topology, and only meaningful with >= 2 nodes of
      // >= 2 ranks — otherwise the star IS the degenerate one-level
      // tree.  Job-wide so every rank rewires (or keeps) its control
      // socket identically.
      reply[3] = (tree_want && valid && !opts_.elastic &&
                  opts_.size / (int)L >= 2)
                     ? 1
                     : 0;
      reply[4] = shm_mismatch.empty() ? 0 : 1;
      // Shm verdict: the segment rings carry the NODE-LOCAL hops, so shm
      // can only arm on the agreed two-level topology (want && valid),
      // and never on elastic jobs (reshapes force the flat ring).  The
      // mode itself is identical job-wide when reply[4] == 0.
      reply[5] = (shm_mode_ != ShmMode::kOff && shm_mismatch.empty() &&
                  want && valid && !opts_.elastic)
                     ? 1
                     : 0;
      for (int r = 1; r < opts_.size; ++r) {
        if (!SendAll(coord_fds_[r], reply, sizeof reply)) {
          *err = "topology agreement send failed";
          return false;
        }
      }
      if (!comp_mismatch.empty()) {
        // The verdict was sent (workers fail with the same typed error);
        // fail init on the coordinator with the full who-said-what story.
        *err = comp_mismatch;
        return false;
      }
      if (!shm_mismatch.empty()) {
        *err = shm_mismatch;
        return false;
      }
    } else {
      // A fresh init can race a PREVIOUS engine's teardown on rank 0
      // (shutdown -> re-init, e.g. the compression convergence test's
      // back-to-back jobs): a running non-elastic coordinator never
      // accepts on its control listener, so this worker's connect can
      // land in the OLD listener's kernel backlog — the hello and the
      // agreement report buffer fine — and die with an RST only when
      // rank 0 finally tears down, while rank 0's NEW init waits for a
      // hello that will never arrive and the job deadlocks until the
      // accept timeout.  The handshake therefore retries WHOLE
      // (reconnect + hello + agreement) until the deadline: a reply can
      // only come from a live init, because replying requires accept().
      auto hs_deadline = std::chrono::steady_clock::now() +
                         std::chrono::duration<double>(kTimeout);
      while (!SendAll(coord_fd_, mine, sizeof mine) ||
             !RecvAll(coord_fd_, reply, sizeof reply)) {
        CloseFd(coord_fd_);
        coord_fd_ = -1;
        double left =
            std::chrono::duration<double>(
                hs_deadline - std::chrono::steady_clock::now())
                .count();
        if (left <= 0.0) {
          *err = "topology agreement exchange failed";
          return false;
        }
        coord_fd_ = ConnectRetry(host, port, left, err);
        if (coord_fd_ < 0) return false;
        uint32_t my_rank = static_cast<uint32_t>(opts_.rank);
        if (!SendAll(coord_fd_, &my_rank, 4)) continue;
      }
      if (reply[2] != 0) {
        *err = "HVD_TPU_COMPRESSION mismatch: the ranks disagree on the "
               "wire-compression configuration (mode or min-bytes floor); "
               "set HVD_TPU_COMPRESSION and HVD_TPU_COMPRESSION_MIN_BYTES "
               "identically on every rank.";
        return false;
      }
      if (reply[4] != 0) {
        *err = "HVD_TPU_SHM mismatch: the ranks disagree on the data-plane "
               "transport mode; set HVD_TPU_SHM identically on every rank.";
        return false;
      }
    }
    opts_.hierarchical_allreduce = reply[0] != 0;
    opts_.cache_capacity = static_cast<int64_t>(reply[1]);
    opts_.coord_tree = reply[3] != 0;
    shm_agreed_ = reply[5] != 0;
    if (shm_mode_ == ShmMode::kForce && !shm_agreed_) {
      *err = "HVD_TPU_SHM=force but the shared-memory transport cannot arm: "
             "it requires the two-level topology (hierarchical allreduce "
             "agreed job-wide: equal local_size >= 2, ranks in contiguous "
             "blocks of local_size) on a non-elastic job; use HVD_TPU_SHM="
             "auto to fall back to TCP instead.";
      return false;
    }
  }
  // (Clock alignment runs at the END of socket setup, AFTER the tree
  // restructure and the data-plane accept loop: under the coordinator
  // tree the probes are RELAYED through the sub-coordinators — rank 0
  // probes only its direct children, each sub composes its own verdict
  // with per-child probes over the tree sockets built below — so rank
  // 0's init fan-in stays O(hosts) instead of the old O(ranks) star.)
  node_id_ = opts_.hierarchical_allreduce ? opts_.rank / opts_.local_size : 0;
  n_nodes_ = opts_.hierarchical_allreduce ? opts_.size / opts_.local_size : 1;
  topo_hier_.store(opts_.hierarchical_allreduce);
  topo_nodes_.store(n_nodes_);

  // Control-plane coordinator tree restructure (docs/performance.md
  // #control-plane-scaling).  The init rendezvous above is a transient
  // O(ranks) star (one bounded round — agreement + clock sync); the
  // STEADY-STATE control plane is what scales, so non-lead workers of
  // nodes >= 1 now re-home their control socket to their node's
  // local-rank-0, which accepts them over its DATA listener with a typed
  // hello (no new endpoints).  Rank 0 keeps one socket per
  // sub-coordinator plus its own node's workers: O(hosts + local_size).
  tree_enabled_ = opts_.coord_tree && opts_.size > 1;
  const int Lc = opts_.local_size;
  const int ctrl_nodes = tree_enabled_ ? opts_.size / Lc : 1;
  is_sub_coord_ =
      tree_enabled_ && opts_.local_rank == 0 && opts_.rank >= Lc;
  ctrl_hosts_.store(ctrl_nodes);
  if (opts_.rank == 0) {
    coord_children_.clear();
    for (int r = 1; r < opts_.size; ++r) {
      bool direct = !tree_enabled_ || r < Lc || r % Lc == 0;
      if (direct) {
        coord_children_.push_back(r);
      } else {
        CloseFd(coord_fds_[r]);
        coord_fds_[r] = -1;
      }
    }
    ctrl_children_.store(static_cast<int>(coord_children_.size()));
  } else if (is_sub_coord_) {
    tree_child_fds_.assign(Lc - 1, -1);
    tree_child_ranks_.clear();
    for (int i = 1; i < Lc; ++i)
      tree_child_ranks_.push_back(opts_.rank + i);
    tree_child_dead_.assign(Lc - 1, false);
    ctrl_children_.store(Lc - 1);
  }

  // Data-plane connections.  Every outgoing connection announces itself
  // with a 4-byte hello (kind in the high byte, sender id in the low 24
  // bits) so one listen socket can serve the global ring, the node-local
  // star, and the cross-node leader ring.  Kernel listen backlogs complete
  // handshakes before accept(2), so every rank can finish all its connects
  // before starting its accepts without deadlock.
  const uint32_t kHelloRing = 0u << 24;
  const uint32_t kHelloLocal = 1u << 24;
  const uint32_t kHelloCross = 2u << 24;
  // Control-plane tree: a non-lead worker's hello to its node's
  // sub-coordinator (id = the worker's global rank).
  const uint32_t kHelloCtrl = 5u << 24;
  auto connect_hello = [&](const std::string& ep, uint32_t hello,
                           std::string* err) -> int {
    std::string h;
    int p;
    if (!ParseEndpoint(ep, &h, &p)) {
      *err = "bad data endpoint " + ep;
      return -1;
    }
    int fd = ConnectRetry(h, p, kTimeout, err);
    if (fd < 0) return -1;
    if (!SendAll(fd, &hello, 4)) {
      *err = "data-plane hello send failed";
      CloseFd(fd);
      return -1;
    }
    return fd;
  };

  bool hier = opts_.hierarchical_allreduce;
  const int L = opts_.local_size;
  // Recursive-doubling tree partners exist only for power-of-two node
  // counts; otherwise the tree path falls back to the ring and no fds
  // are built.
  int tree_levels = 0;
  if (hier && n_nodes_ > 1 && (n_nodes_ & (n_nodes_ - 1)) == 0)
    for (int m = n_nodes_; m > 1; m >>= 1) ++tree_levels;
  const uint32_t kHelloTree = 4u << 24;
  // Control-tree re-home: a non-lead worker of a node >= 1 drops its
  // init-star socket to rank 0 and connects to its sub-coordinator's
  // data listener instead (rank 0 closed its end above symmetrically).
  if (tree_enabled_ && opts_.rank >= Lc && opts_.local_rank != 0) {
    CloseFd(coord_fd_);
    int lead = opts_.rank - opts_.local_rank;
    coord_fd_ = connect_hello(opts_.data_endpoints[lead],
                              kHelloCtrl | (uint32_t)opts_.rank, err);
    if (coord_fd_ < 0) {
      *err = "control-tree connect to the sub-coordinator failed: " + *err;
      return false;
    }
  }
  // Connect to the right global-ring neighbour.
  int right = (opts_.rank + 1) % opts_.size;
  right_fd_ = connect_hello(opts_.data_endpoints[right],
                            kHelloRing | (uint32_t)opts_.rank, err);
  if (right_fd_ < 0) return false;
  // Heartbeat beacon sockets (docs/fault-tolerance.md#failure-detection):
  // rank r dials (r+1)%size and accepts (r-1+size)%size over the same
  // data listener, typed hello kind 6 with the membership epoch in bits
  // 16-23 (init epoch 0) and the sender rank in the low 16.  Dedicated
  // fds, full-duplex, owned by the monitor thread — never the ring's.
  const uint32_t kHelloBeat = 6u << 24;
  const bool want_beats = hb_interval_ms_ > 0;
  if (want_beats) {
    int bfd = connect_hello(
        opts_.data_endpoints[right],
        kHelloBeat | ((uint32_t)opts_.rank & 0xffffu), err);
    if (bfd < 0) {
      *err = "heartbeat beacon connect failed: " + *err;
      return false;
    }
    std::lock_guard<std::mutex> lk(hb_mu_);
    beat_out_fd_ = bfd;
    beat_out_peer_ = right;
  }
  if (hier) {
    // Node-local ring: every rank connects to its right local neighbour
    // (same node, local_rank+1 mod L) — the hop the local reduce-scatter
    // and allgather phases run over.
    int node_base = opts_.rank - opts_.local_rank;
    int local_right = node_base + (opts_.local_rank + 1) % L;
    local_right_fd_ = connect_hello(
        opts_.data_endpoints[local_right],
        kHelloLocal | (uint32_t)opts_.local_rank, err);
    if (local_right_fd_ < 0) return false;
  }
  if (hier && n_nodes_ > 1) {
    // Sharded cross-node ring: EVERY local rank connects to its
    // same-local-rank peer on the next node, so each of the local_size
    // shards crosses the DCN on its own stream (the single-leader-NIC
    // bottleneck this topology replaces).
    int peer = ((node_id_ + 1) % n_nodes_) * L + opts_.local_rank;
    cross_right_fd_ = connect_hello(opts_.data_endpoints[peer],
                                    kHelloCross | (uint32_t)node_id_, err);
    if (cross_right_fd_ < 0) return false;
    // Tree partners: for each XOR level the side with the level bit
    // CLEAR connects, the side with it SET accepts — exactly one
    // connection per partner pair per level.
    cross_tree_fds_.assign(tree_levels, -1);
    for (int k = 0; k < tree_levels; ++k) {
      if (node_id_ & (1 << k)) continue;  // this side accepts
      int p = (node_id_ ^ (1 << k)) * L + opts_.local_rank;
      cross_tree_fds_[k] = connect_hello(
          opts_.data_endpoints[p],
          kHelloTree | ((uint32_t)k << 16) | (uint32_t)node_id_, err);
      if (cross_tree_fds_[k] < 0) return false;
    }
  }

  int expected = 1;  // left global-ring neighbour
  if (hier) {
    expected += 1;  // left local-ring neighbour
    if (n_nodes_ > 1) {
      expected += 1;  // cross-ring left neighbour
      for (int k = 0; k < tree_levels; ++k)
        if (node_id_ & (1 << k)) expected += 1;  // tree partner connects
    }
  }
  if (is_sub_coord_) expected += Lc - 1;  // this node's control sockets
  if (want_beats) expected += 1;          // left neighbour's beat socket
  const int beat_left = (opts_.rank + opts_.size - 1) % opts_.size;
  for (int i = 0; i < expected; ++i) {
    int fd = AcceptOne(data_listen_fd_, kTimeout, err);
    if (fd < 0) return false;
    uint32_t hello;
    if (!RecvAll(fd, &hello, 4)) {
      *err = "data-plane hello recv failed";
      CloseFd(fd);
      return false;
    }
    uint32_t kind = hello & 0xff000000u;
    uint32_t id = hello & 0x00ffffffu;
    if (kind == kHelloRing && left_fd_ < 0) {
      left_fd_ = fd;
    } else if (kind == kHelloLocal && hier && local_left_fd_ < 0 &&
               id == (uint32_t)((opts_.local_rank + L - 1) % L)) {
      local_left_fd_ = fd;
    } else if (kind == kHelloCross && hier && n_nodes_ > 1 &&
               cross_left_fd_ < 0) {
      cross_left_fd_ = fd;
    } else if (kind == kHelloTree && hier && n_nodes_ > 1) {
      int k = (int)((id >> 16) & 0xff);
      if (k >= tree_levels || !(node_id_ & (1 << k)) ||
          cross_tree_fds_[k] >= 0) {
        *err = "unexpected tree-partner hello " + std::to_string(hello);
        CloseFd(fd);
        return false;
      }
      cross_tree_fds_[k] = fd;
    } else if (kind == kHelloCtrl && is_sub_coord_) {
      int child = static_cast<int>(id) - opts_.rank - 1;
      if (child < 0 || child >= Lc - 1 || tree_child_fds_[child] >= 0) {
        *err = "unexpected control-tree hello " + std::to_string(hello);
        CloseFd(fd);
        return false;
      }
      tree_child_fds_[child] = fd;
    } else if (kind == kHelloBeat && want_beats &&
               (id & 0xffffu) == (uint32_t)beat_left &&
               ((id >> 16) & 0xff) == 0) {
      std::lock_guard<std::mutex> lk(hb_mu_);
      if (beat_in_fd_ >= 0) {
        *err = "duplicate heartbeat hello " + std::to_string(hello);
        CloseFd(fd);
        return false;
      }
      beat_in_fd_ = fd;
      beat_in_peer_ = beat_left;
    } else {
      *err = "unexpected data-plane hello " + std::to_string(hello);
      CloseFd(fd);
      return false;
    }
  }
  if (left_fd_ < 0) {
    *err = "global ring left neighbour never connected";
    return false;
  }
  if (hier && local_left_fd_ < 0) {
    *err = "node-local ring left neighbour never connected";
    return false;
  }
  if (is_sub_coord_)
    for (int i = 0; i < Lc - 1; ++i)
      if (tree_child_fds_[i] < 0) {
        *err = "control-tree worker rank " +
               std::to_string(tree_child_ranks_[i]) + " never connected";
        return false;
      }
  if (want_beats && beat_in_fd_ < 0) {
    *err = "heartbeat beacon left neighbour never connected";
    return false;
  }
  // fd -> peer-rank registry (net.h): every data/control/beat fd maps to
  // the rank at its far end.  HVD_TPU_NET_FAULT_SPEC clauses naming
  // ranks resolve to sockets through it, and the per-link telemetry
  // (NetLinkInfo) attributes bytes/latency through the SAME map — so
  // registration is unconditional now (the fault hot path still costs
  // one relaxed atomic when no spec is armed).  The beat fds register
  // too — a partitioned link MUST also silence its beacons, or the
  // detector could never see the partition it exists to detect.
  {
    NetFaultRegister(right_fd_, right);
    NetFaultRegister(left_fd_, beat_left);
    if (hier) {
      int node_base = opts_.rank - opts_.local_rank;
      NetFaultRegister(local_right_fd_,
                       node_base + (opts_.local_rank + 1) % L);
      NetFaultRegister(local_left_fd_,
                       node_base + (opts_.local_rank + L - 1) % L);
      if (n_nodes_ > 1) {
        NetFaultRegister(cross_right_fd_,
                         ((node_id_ + 1) % n_nodes_) * L + opts_.local_rank);
        NetFaultRegister(cross_left_fd_, ((node_id_ + n_nodes_ - 1) %
                                          n_nodes_) * L + opts_.local_rank);
        for (int k = 0; k < tree_levels; ++k)
          if (cross_tree_fds_[k] >= 0)
            NetFaultRegister(cross_tree_fds_[k],
                             (node_id_ ^ (1 << k)) * L + opts_.local_rank);
      }
    }
    if (opts_.rank == 0) {
      for (int r : coord_children_) NetFaultRegister(coord_fds_[r], r);
    } else {
      NetFaultRegister(coord_fd_, (tree_enabled_ && opts_.rank >= Lc &&
                                   opts_.local_rank != 0)
                                      ? opts_.rank - opts_.local_rank
                                      : 0);
      for (size_t i = 0; i < tree_child_fds_.size(); ++i)
        NetFaultRegister(tree_child_fds_[i], tree_child_ranks_[i]);
    }
    std::lock_guard<std::mutex> lk(hb_mu_);
    NetFaultRegister(beat_out_fd_, beat_out_peer_);
    NetFaultRegister(beat_in_fd_, beat_in_peer_);
  }
  // Transport seam: wrap the topology fds in channels and run the shm
  // segment rendezvous when the job-wide agreement armed it.  Before the
  // monitor wake registry (the segment joins it) and before ClockSync
  // (a force-mode failure must surface as the init verdict).
  if (!SetupShmTransport(err)) return false;
  // Arm the monitor's wake registry: the data-plane fds the engine thread
  // can block in (ring exchanges), shut down by the monitor when it
  // flags a silent peer so a survivor wakes in O(heartbeat) instead of
  // stalling transitively behind the frozen rank.  NEVER the beat fds
  // (the gossip must keep flowing) and never the control fds (only
  // hb_ctrl_wake_fd_, at the local-abort escalation).
  {
    std::lock_guard<std::mutex> lk(hb_mu_);
    hb_wake_fds_.clear();
    hb_wake_fds_.push_back(left_fd_);
    hb_wake_fds_.push_back(right_fd_);
    if (local_left_fd_ >= 0) hb_wake_fds_.push_back(local_left_fd_);
    if (local_right_fd_ >= 0) hb_wake_fds_.push_back(local_right_fd_);
    if (cross_left_fd_ >= 0) hb_wake_fds_.push_back(cross_left_fd_);
    if (cross_right_fd_ >= 0) hb_wake_fds_.push_back(cross_right_fd_);
    for (int fd : cross_tree_fds_)
      if (fd >= 0) hb_wake_fds_.push_back(fd);
    hb_wake_shm_ = shm_active_ ? &shm_seg_ : nullptr;
    hb_ctrl_wake_fd_ = opts_.rank == 0 ? -1 : coord_fd_;
    // Monitored peers start "just seen": the first miss window opens at
    // init, not at the epoch of the clock.
    int64_t now_us = EpochNowUs();
    if (beat_in_peer_ >= 0) hb_last_seen_us_[beat_in_peer_] = now_us;
    if (beat_out_peer_ >= 0) hb_last_seen_us_[beat_out_peer_] = now_us;
  }
  // Clock alignment for the per-rank timelines (docs/timeline.md),
  // relayed through the coordinator tree when one was just built.
  if (!ClockSync(err)) return false;
  return true;
}

namespace {
// Attach-token relay words (ASCII-tagged for strace readability).
constexpr uint32_t kShmRound1Ok = 0x53484d31;   // "SHM1"
constexpr uint32_t kShmRound1Bad = 0x53484d30;  // "SHM0"
constexpr uint32_t kShmRound2Arm = 0x53484d41;  // "SHMA"
constexpr uint32_t kShmRound2Tcp = 0x53484d54;  // "SHMT"

bool ShmTokenSend(int fd, uint32_t tok) { return SendAll(fd, &tok, 4); }
bool ShmTokenRecv(int fd, uint32_t* tok) {
  return WaitReadable(fd, 30.0) && RecvAll(fd, tok, 4);
}
}  // namespace

bool Engine::SetupShmTransport(std::string* err) {
  const int L = opts_.hierarchical_allreduce ? opts_.local_size : 1;
  const int node_base = node_id_ * L;
  const int lr = opts_.local_rank;
  // The channels wrap every topology fd unconditionally — the TCP path
  // is simply a channel with no rings — so the data-plane code has ONE
  // seam instead of an fd path and a ring path.
  left_ch_ = Channel{left_fd_, nullptr, nullptr,
                     (opts_.rank + opts_.size - 1) % opts_.size};
  right_ch_ = Channel{right_fd_, nullptr, nullptr,
                      (opts_.rank + 1) % opts_.size};
  local_left_ch_ = Channel{local_left_fd_, nullptr, nullptr,
                           node_base + (lr + L - 1) % L};
  local_right_ch_ = Channel{local_right_fd_, nullptr, nullptr,
                            node_base + (lr + 1) % L};
  cross_left_ch_ = Channel{
      cross_left_fd_, nullptr, nullptr,
      ((node_id_ + n_nodes_ - 1) % n_nodes_) * L + lr};
  cross_right_ch_ = Channel{cross_right_fd_, nullptr, nullptr,
                            ((node_id_ + 1) % n_nodes_) * L + lr};
  if (!shm_agreed_) return true;
  // Chaos interop (the never-silently-ignored contract): a
  // fault clause naming ANY in-node ring link decides the node's
  // transport before the segment exists.  delay/jitter clauses apply at
  // the shm seam (NetFaultDelayPeer per handoff); drop/flaky/partition
  // shapes cannot be expressed by a memory fence, so they demote the
  // node to TCP (auto) or fail init typed (force).  Every local rank
  // scans ALL in-node links, so the whole node reaches one verdict with
  // no extra rendezvous round.
  bool chaos_tcp = false;
  for (int i = 0; i < L && !chaos_tcp; ++i) {
    std::string clause;
    int verdict = NetFaultQueryLink(node_base + i, node_base + (i + 1) % L,
                                    &clause);
    if (verdict == 2) {
      if (shm_mode_ == ShmMode::kForce) {
        *err = "HVD_TPU_SHM=force but HVD_TPU_NET_FAULT_SPEC clause '" +
               clause + "' injects a drop/flaky/partition fault on the "
               "same-host link " + std::to_string(node_base + i) + "-" +
               std::to_string(node_base + (i + 1) % L) +
               ", which the shared-memory transport cannot express; "
               "drop the clause or use HVD_TPU_SHM=auto (TCP fallback).";
        return false;
      }
      if (lr == 0)
        fprintf(stderr,
                "[horovod_tpu] WARNING: HVD_TPU_NET_FAULT_SPEC clause "
                "'%s' injects a drop/flaky fault on a same-host link; "
                "node %d keeps the TCP transport (HVD_TPU_SHM=auto "
                "demotes, it never silently ignores a clause).\n",
                clause.c_str(), node_id_);
      chaos_tcp = true;
    }
  }
  if (chaos_tcp) return true;
  // Segment name: job tag (coordinator endpoint — unique per job on a
  // host) + node + epoch (launcher restart epoch composed with the
  // elastic membership epoch), so restarts and reshapes can never
  // attach a stale generation's segment.
  const char* re_env = getenv("HVD_TPU_RESTART_EPOCH");
  long long restart_epoch = (re_env && *re_env) ? atoll(re_env) : 0;
  long long epoch = restart_epoch * 1000000 + membership_epoch_.load();
  std::string name = ShmSegmentName(opts_.coord_endpoint, node_id_, epoch);
  // Two-round token relay over the node-local ring sockets (already
  // connected, already chaos-registered).  Round 1 (attach): local rank
  // 0 creates, then an Ok token circulates rightward with every rank
  // attaching before forwarding (any failure flips it to Bad).  Round 2
  // (verdict): the creator UNLINKS THE NAME FIRST — every rank is
  // attached or the node is abandoning shm, so from here no abort,
  // typed death, or SIGKILL can leak a /dev/shm entry — then circulates
  // Arm/Tcp so every rank flips its channels in the same tick.
  uint32_t tok = 0;
  std::string seg_err;
  bool attached = false;
  if (lr == 0) {
    attached = shm_seg_.Create(name, L, (size_t)shm_ring_bytes_, &seg_err);
    if (!ShmTokenSend(local_right_fd_, attached ? kShmRound1Ok
                                                : kShmRound1Bad) ||
        !ShmTokenRecv(local_left_fd_, &tok)) {
      *err = "shm attach-token relay failed on the node-local ring";
      return false;
    }
    shm_seg_.Unlink();
    bool arm = attached && tok == kShmRound1Ok;
    uint32_t verdict = arm ? kShmRound2Arm : kShmRound2Tcp;
    if (!ShmTokenSend(local_right_fd_, verdict) ||
        !ShmTokenRecv(local_left_fd_, &tok) || tok != verdict) {
      *err = "shm verdict-token relay failed on the node-local ring";
      return false;
    }
  } else {
    if (!ShmTokenRecv(local_left_fd_, &tok)) {
      *err = "shm attach-token relay failed on the node-local ring";
      return false;
    }
    if (tok == kShmRound1Ok) {
      attached = shm_seg_.Attach(name, L, (size_t)shm_ring_bytes_, &seg_err);
      if (!attached) tok = kShmRound1Bad;
    }
    if (!ShmTokenSend(local_right_fd_, tok) ||
        !ShmTokenRecv(local_left_fd_, &tok) ||
        !ShmTokenSend(local_right_fd_, tok)) {
      *err = "shm verdict-token relay failed on the node-local ring";
      return false;
    }
  }
  if (tok != kShmRound2Arm) {
    shm_seg_.Unmap();
    if (shm_mode_ == ShmMode::kForce) {
      *err = "HVD_TPU_SHM=force but the node " + std::to_string(node_id_) +
             " segment could not arm" +
             (seg_err.empty() ? std::string(" (a peer failed to attach)")
                              : ": " + seg_err) +
             "; use HVD_TPU_SHM=auto to fall back to TCP instead.";
      return false;
    }
    if (lr == 0)
      fprintf(stderr,
              "[horovod_tpu] WARNING: shared-memory transport could not "
              "arm on node %d (%s); falling back to TCP.\n",
              node_id_, seg_err.empty() ? "a peer failed to attach"
                                        : seg_err.c_str());
    return true;
  }
  // Armed: point the node-local channels at the segment rings.  Ring
  // (r, 0) flows rightward (r writes, (r+1)%L reads), ring (r, 1)
  // leftward — so this rank SENDS right on (lr, 0) and left on (lr, 1),
  // RECEIVES from the left neighbour's rightward ring and the right
  // neighbour's leftward ring.
  local_right_ch_.tx = shm_seg_.Ring(lr, 0);
  local_right_ch_.rx = shm_seg_.Ring((lr + 1) % L, 1);
  local_left_ch_.tx = shm_seg_.Ring(lr, 1);
  local_left_ch_.rx = shm_seg_.Ring((lr + L - 1) % L, 0);
  shm_active_ = true;
  topo_shm_.store(true);
  if (flight_.Enabled())
    flight_.Record(FL_TRANSPORT, "shm", (int64_t)shm_ring_bytes_);
  if (lr == 0)
    fprintf(stderr,
            "[horovod_tpu] node %d local ring on shared-memory transport "
            "(%d ranks, %lld-byte rings, segment unlinked).\n",
            node_id_, L, (long long)shm_ring_bytes_);
  return true;
}

void Engine::TeardownSockets() {
  {
    // The monitor is already joined (Shutdown) or was never started
    // (init failure); clear its wake registry BEFORE any CloseFd below
    // so no path can ever shut down a recycled fd number, and reap any
    // beat fds it never got to.
    std::lock_guard<std::mutex> lk(hb_mu_);
    hb_wake_fds_.clear();
    hb_wake_shm_ = nullptr;
    hb_ctrl_wake_fd_ = -1;
    CloseFd(beat_in_fd_);
    CloseFd(beat_out_fd_);
    beat_in_fd_ = beat_out_fd_ = -1;
    beat_in_peer_ = beat_out_peer_ = -1;
    for (int fd : hb_graveyard_) CloseFd(fd);
    hb_graveyard_.clear();
  }
  CloseFd(coord_listen_fd_);
  CloseFd(coord_fd_);
  for (int fd : coord_fds_) CloseFd(fd);
  coord_fds_.clear();
  if (coord_) {
    // Standbys parked for an admission that will never come (plus any
    // half-done handshakes): their processes see EOF and exit instead of
    // blocking on a closed coordinator.
    for (int fd : coord_->pending_join_fds) CloseFd(fd);
    coord_->pending_join_fds.clear();
    coord_->pending_join_endpoints.clear();
    for (const auto& hs : coord_->handshaking) CloseFd(hs.fd);
    coord_->handshaking.clear();
  }
  for (int fd : tree_child_fds_) CloseFd(fd);
  tree_child_fds_.clear();
  tree_child_ranks_.clear();
  tree_child_dead_.clear();
  coord_children_.clear();
  CloseFd(data_listen_fd_);
  CloseFd(left_fd_);
  CloseFd(right_fd_);
  CloseTopologyFds();
  CloseP2pChannels();
  coord_listen_fd_ = coord_fd_ = data_listen_fd_ = left_fd_ = right_fd_ = -1;
  left_ch_ = Channel{};
  right_ch_ = Channel{};
}

void Engine::ShutdownTopologyFds() {
  ShutdownFd(local_left_fd_);
  ShutdownFd(local_right_fd_);
  ShutdownFd(cross_left_fd_);
  ShutdownFd(cross_right_fd_);
  for (int fd : cross_tree_fds_) ShutdownFd(fd);
  // Dedicated p2p channels: a peer blocked mid-transfer wakes too.  The
  // fds close with CloseP2pChannels (teardown / ring rebuild).
  for (auto& kv : p2p_chans_) ShutdownFd(kv.second.fd);
  // Shm analogue of ShutdownFd: a helper (or peer) blocked in a ring
  // drive loop wakes within one poll iteration.  Unmap stays with
  // CloseTopologyFds, after the helpers joined.
  shm_seg_.CloseRings();
}

void Engine::CloseTopologyFds() {
  CloseFd(local_left_fd_);
  CloseFd(local_right_fd_);
  CloseFd(cross_left_fd_);
  CloseFd(cross_right_fd_);
  for (int fd : cross_tree_fds_) CloseFd(fd);
  cross_tree_fds_.clear();
  local_left_fd_ = local_right_fd_ = -1;
  cross_left_fd_ = cross_right_fd_ = -1;
  // Segment teardown.  The name was already unlinked the moment the
  // attach token round-tripped; the extra Unlink here covers the
  // create-to-attach window on an init failure, so no typed death path
  // can leak a /dev/shm entry.  De-register from the monitor BEFORE
  // unmapping (it may be mid-CloseRings on the mapping).
  {
    std::lock_guard<std::mutex> lk(hb_mu_);
    hb_wake_shm_ = nullptr;
  }
  shm_seg_.Unlink();
  shm_seg_.Unmap();
  shm_active_ = false;
  topo_shm_.store(false);
  // Only the TOPOLOGY channels: the flat-ring pair (left_ch_/right_ch_)
  // tracks left_fd_/right_fd_, which outlive a two-level teardown (the
  // flat ring keeps serving broadcast/allgather after a failed
  // hierarchical collective latched the topology closed).
  local_left_ch_ = Channel{};
  local_right_ch_ = Channel{};
  cross_left_ch_ = Channel{};
  cross_right_ch_ = Channel{};
}

int64_t Engine::EpochNowUs() const {
  return std::chrono::duration_cast<std::chrono::microseconds>(
             std::chrono::steady_clock::now() - epoch_)
      .count();
}

bool Engine::ClockSync(std::string* err) {
  // K round trips per probed peer; the minimum-RTT sample gives the best
  // offset estimate (symmetric-path assumption: the peer's timestamp was
  // taken at the probe's midpoint), its RTT the error bound.  The
  // verdict is sent back so each rank knows its own offset — each rank's
  // timeline records it for tools/timeline_merge.py.
  //
  // Under the coordinator tree the sync RELAYS: rank 0 probes only its
  // direct children — O(hosts + local_size), not the O(ranks) star this
  // replaced — and each sub-coordinator, once it holds its own verdict
  // (offset o_s, error r_s), probes its leaves against ITS clock
  // (offset o_c) and hands them the composed verdict {o_s + o_c,
  // r_s + r_c}: leaf_clock = rank0_clock + o_s + o_c, with the error
  // bounds summing along the relay path.
  const int kProbes = 8;
  if (opts_.size == 1) return true;
  auto probe_peer = [&](int fd, int64_t* best_off,
                        int64_t* best_rtt) -> bool {
    *best_rtt = -1;
    *best_off = 0;
    for (int k = 0; k < kProbes; ++k) {
      uint8_t probe = 1;
      int64_t t0 = EpochNowUs();
      if (!SendAll(fd, &probe, 1)) return false;
      int64_t peer_ts;
      if (!RecvAll(fd, &peer_ts, 8)) return false;
      int64_t t1 = EpochNowUs();
      int64_t rtt = t1 - t0;
      if (*best_rtt < 0 || rtt < *best_rtt) {
        *best_rtt = rtt;
        *best_off = peer_ts - (t0 + t1) / 2;
      }
    }
    return true;
  };
  auto serve_probes = [&](int fd) -> bool {
    for (int k = 0; k < kProbes; ++k) {
      uint8_t probe;
      if (!RecvAll(fd, &probe, 1)) return false;
      int64_t now = EpochNowUs();
      if (!SendAll(fd, &now, 8)) return false;
    }
    return true;
  };
  if (opts_.rank == 0) {
    int probed = 0;
    for (int r : coord_children_) {
      int64_t off, rtt;
      if (!probe_peer(coord_fds_[r], &off, &rtt)) {
        *err = "clock sync probe failed (rank " + std::to_string(r) + ")";
        return false;
      }
      ++probed;
      int64_t verdict[2] = {off, rtt};
      if (!SendAll(coord_fds_[r], verdict, sizeof verdict)) {
        *err = "clock sync verdict send failed (rank " + std::to_string(r) +
               ")";
        return false;
      }
    }
    clock_fanin_.store(probed);
  } else {
    if (!serve_probes(coord_fd_)) {
      *err = "clock sync probe recv failed";
      return false;
    }
    int64_t verdict[2];
    if (!RecvAll(coord_fd_, verdict, sizeof verdict)) {
      *err = "clock sync verdict recv failed";
      return false;
    }
    clock_offset_us_.store(verdict[0]);
    clock_rtt_us_.store(verdict[1]);
    // Sub-coordinator relay leg (tree_child_fds_ is empty off the tree).
    int probed = 0;
    for (size_t i = 0; i < tree_child_fds_.size(); ++i) {
      int64_t off, rtt;
      if (!probe_peer(tree_child_fds_[i], &off, &rtt)) {
        *err = "clock sync relay probe failed (rank " +
               std::to_string(tree_child_ranks_[i]) + ")";
        return false;
      }
      ++probed;
      int64_t composed[2] = {verdict[0] + off, verdict[1] + rtt};
      if (!SendAll(tree_child_fds_[i], composed, sizeof composed)) {
        *err = "clock sync relay verdict send failed (rank " +
               std::to_string(tree_child_ranks_[i]) + ")";
        return false;
      }
    }
    if (probed > 0) clock_fanin_.store(probed);
  }
  return true;
}

void Engine::RecordAnnounce(int last_rank, int64_t skew_us) {
  if (skew_us < 0) skew_us = 0;
  std::lock_guard<std::mutex> lk(announce_mu_);
  ++announce_events_;
  if (last_rank >= 0 &&
      last_rank < static_cast<int>(last_announce_counts_.size()))
    ++last_announce_counts_[last_rank];
  announce_log_.emplace_back(last_rank, skew_us);
  while (announce_log_.size() > 1024) announce_log_.pop_front();
}

int64_t Engine::AnnounceEvents() {
  std::lock_guard<std::mutex> lk(announce_mu_);
  return announce_events_;
}

std::string Engine::AnnounceLog() {
  // The cumulative event count is PREFIXED ("count:entries") under the
  // same lock hold as the log serialization: a reader pairing a separate
  // AnnounceEvents() call with this log could race concurrent
  // negotiations and mis-window the entries (dropping or double-counting
  // skew samples).
  std::lock_guard<std::mutex> lk(announce_mu_);
  std::string out = std::to_string(announce_events_) + ":";
  bool first = true;
  for (const auto& rec : announce_log_) {
    if (!first) out += ';';
    first = false;
    out += std::to_string(rec.first) + "|" + std::to_string(rec.second);
  }
  return out;
}

std::string Engine::LastAnnounceCounts() {
  std::lock_guard<std::mutex> lk(announce_mu_);
  std::string out;
  for (size_t i = 0; i < last_announce_counts_.size(); ++i) {
    if (i) out += ',';
    out += std::to_string(last_announce_counts_[i]);
  }
  return out;
}

void Engine::Shutdown() {
  if (!initialized_.load()) return;
  shut_down_.store(true);
  // BackgroundLoop's exit path drains the table and fails pending entries;
  // after join there is nothing left to complete (new Enqueues are rejected
  // once loop_exited_ flips under mu_).
  if (background_.joinable()) background_.join();
  StopHeartbeatMonitor();
  StopAnomalyMonitor();
  timeline_.Shutdown();
  TeardownSockets();
  initialized_.store(false);
}

void Engine::StopAnomalyMonitor() {
  anomaly_stop_.store(true);
  if (anomaly_thread_.joinable()) anomaly_thread_.join();
}

void Engine::StopHeartbeatMonitor() {
  hb_stop_.store(true);
  {
    // Wake the monitor out of any beat-socket poll; the fds stay
    // allocated (shutdown, not close) until after the join.
    std::lock_guard<std::mutex> lk(hb_mu_);
    ShutdownFd(beat_in_fd_);
    ShutdownFd(beat_out_fd_);
  }
  if (hb_thread_.joinable()) hb_thread_.join();
  // TeardownSockets reaps the beat fds and the graveyard.
}

void Engine::HeartbeatLoop() {
  // Monitor thread contract (docs/fault-tolerance.md#failure-detection):
  // beacons out and liveness in over the two dedicated beat fds, NEVER a
  // control or ring socket, and no engine state beyond the hb_mu_-guarded
  // block — escalation is queued for the engine thread (MarkRankDead and
  // AbortLocal clear coordinator tables and the response cache, which
  // only that thread may touch).  The one cross-thread action it takes
  // is ShutdownFd on registered fds, which is the wake primitive.
  const int64_t interval_us = static_cast<int64_t>(hb_interval_ms_) * 1000;
  const int64_t window_us = interval_us * hb_miss_limit_;
  std::vector<uint8_t> bufs[2];
  bool eofs[2] = {false, false};
  int cached_fds[2] = {-2, -2};
  int cached_peers[2] = {-1, -1};
  int64_t cached_epoch = -1;
  std::vector<int> suspects;       // flagged this epoch (local + gossip)
  int64_t grace_deadline_us = -1;  // -1 unarmed, -2 fired
  int64_t last_beat_us = 0;
  uint32_t seq = 0;
  // Echo-RTT send-stamp ring (per-link RTT telemetry, net.h
  // NetLinkRecordRtt): beacon seq -> send time, 256 deep — ~25s of
  // beacons at the default cadence, far past any echo's plausible
  // return, so a match is never a wrapped stale seq.
  uint32_t echo_seq[256];
  int64_t echo_ts[256];
  for (int i = 0; i < 256; ++i) {
    echo_seq[i] = 0xffffffffu;
    echo_ts[i] = 0;
  }

  auto flagged = [&](int peer) {
    for (int s : suspects)
      if (s == peer) return true;
    return false;
  };
  auto flag = [&](int peer) {
    if (flagged(peer)) return;
    suspects.push_back(peer);
    hb_miss_events_.fetch_add(1);
    if (flight_.Enabled()) flight_.Record(FL_HEARTBEAT_MISS, "flag", peer);
    {
      std::lock_guard<std::mutex> lk(hb_mu_);
      if (cur_rank_.load() == 0)
        pending_hb_dead_.push_back(peer);
      else
        pending_hb_report_.push_back(peer);
      // Wake the engine thread out of any ring exchange: with a frozen
      // participant the whole ring stalls transitively, so the job is
      // headed for a reshape (elastic) or an abort either way — breaking
      // the data links now converts an O(collective-timeout) hang into
      // an O(heartbeat) typed verdict.  The registry is cleared by the
      // engine (under this same mutex) before any of these fds is
      // closed, so a recycled fd number can never be hit.
      for (int fd : hb_wake_fds_) ShutdownFd(fd);
      // Same wake for the shm transport: closing the segment's rings
      // breaks any drive loop blocked on a full/empty ring within one
      // poll iteration.  The registry entry is cleared (under this
      // mutex) before the engine unmaps, so no use-after-unmap.
      if (hb_wake_shm_) hb_wake_shm_->CloseRings();
    }
    if (grace_deadline_us == -1) {
      // One more miss window for the coordinated path (reports up, typed
      // abort or reshape broadcast back) before concluding the
      // coordinator itself is unreachable (partition) and escalating
      // locally.  Elastic jobs get extra slack: a reshape needs a full
      // revoke + barrier round trip.
      int64_t extra = opts_.elastic ? 2000000 : 0;
      grace_deadline_us = EpochNowUs() + window_us + extra;
    }
    queue_cv_.notify_all();
  };

  while (!hb_stop_.load()) {
    int fds[2], peers[2];
    int64_t ep;
    {
      std::lock_guard<std::mutex> lk(hb_mu_);
      for (int fd : hb_graveyard_) CloseFd(fd);
      hb_graveyard_.clear();
      fds[0] = beat_in_fd_;
      fds[1] = beat_out_fd_;
      peers[0] = beat_in_peer_;
      peers[1] = beat_out_peer_;
      ep = hb_epoch_;
    }
    if (ep != cached_epoch) {
      cached_epoch = ep;
      suspects.clear();
      grace_deadline_us = -1;
    }
    for (int i = 0; i < 2; ++i)
      if (fds[i] != cached_fds[i]) {
        cached_fds[i] = fds[i];
        cached_peers[i] = peers[i];
        bufs[i].clear();
        eofs[i] = false;
      }
    if (fds[0] < 0 && fds[1] < 0) {
      // Solo (or between reshapes): nothing to monitor yet.
      std::this_thread::sleep_for(
          std::chrono::milliseconds(hb_interval_ms_));
      continue;
    }
    int64_t now = EpochNowUs();
    if (now - last_beat_us >= interval_us) {
      last_beat_us = now;
      HeartbeatFrame hb;
      hb.sender_rank = static_cast<uint32_t>(cur_rank_.load());
      hb.epoch = static_cast<uint32_t>(ep);
      hb.seq = seq++;
      echo_seq[hb.seq & 0xffu] = hb.seq;
      echo_ts[hb.seq & 0xffu] = now;
      uint8_t frame[kHeartbeatFrameBytes];
      SerializeHeartbeat(hb, frame);
      for (int i = 0; i < 2; ++i)
        if (fds[i] >= 0 && SendAll(fds[i], frame, sizeof frame))
          hb_sent_.fetch_add(1);
      // Suspect gossip: repeat every accusation each interval so it hops
      // rank to rank even when the frozen rank sits between the accuser
      // and rank 0 (the mid-steady partition story).
      for (int s : suspects) {
        HeartbeatFrame g;
        g.magic = kSuspectMagic;
        g.sender_rank = hb.sender_rank;
        g.epoch = hb.epoch;
        g.seq = static_cast<uint32_t>(s);
        SerializeHeartbeat(g, frame);
        for (int i = 0; i < 2; ++i)
          if (fds[i] >= 0) SendAll(fds[i], frame, sizeof frame);
      }
      // Miss accounting for the (up to two) directly monitored peers.
      std::vector<int> to_flag;
      {
        std::lock_guard<std::mutex> lk(hb_mu_);
        for (int i = 0; i < 2; ++i) {
          int peer = cached_peers[i];
          if (peer < 0 || (i == 1 && peer == cached_peers[0])) continue;
          auto it = hb_last_seen_us_.find(peer);
          if (it == hb_last_seen_us_.end())
            it = hb_last_seen_us_.emplace(peer, now).first;
          int misses = static_cast<int>((now - it->second) / interval_us);
          hb_miss_counts_[peer] = misses;
          if (misses >= hb_miss_limit_) to_flag.push_back(peer);
        }
      }
      for (int peer : to_flag) flag(peer);
    }
    if (grace_deadline_us >= 0 && now > grace_deadline_us) {
      grace_deadline_us = -2;
      if (abort_code_.load() == 0 && !suspects.empty()) {
        // The coordinated escalation never came back: the path to rank 0
        // is itself dead (network partition).  Latch the typed local
        // verdict for the engine thread and break its parent wait.
        std::vector<int> sorted = suspects;
        std::sort(sorted.begin(), sorted.end());
        std::string csv;
        for (int s : sorted)
          csv += (csv.empty() ? "" : ", ") + std::to_string(s);
        {
          std::lock_guard<std::mutex> lk(hb_mu_);
          hb_local_abort_msg_ =
              "ranks down: " + csv +
              " (no data-plane heartbeats within the detection window; "
              "process(es) frozen or network partitioned, and the "
              "coordinator is unreachable). The job was aborted; restart "
              "it (e.g. hvdrun --max-restarts) to resume from the latest "
              "checkpoint.";
          hb_local_abort_.store(true);
          ShutdownFd(hb_ctrl_wake_fd_);
        }
        if (flight_.Enabled())
          flight_.Record(FL_HEARTBEAT_MISS, "local-abort", sorted[0]);
        queue_cv_.notify_all();
      }
    }
    // Nap, then drain whatever beacons arrived.  The nap paces the loop
    // well under the beat interval so send jitter never costs a miss.
    int nap_ms = hb_interval_ms_ / 4;
    if (nap_ms < 1) nap_ms = 1;
    if (nap_ms > 25) nap_ms = 25;
    std::this_thread::sleep_for(std::chrono::milliseconds(nap_ms));
    for (int i = 0; i < 2; ++i) {
      if (cached_fds[i] < 0 || eofs[i]) continue;
      if (!RecvAvailable(cached_fds[i], &bufs[i])) {
        // EOF/error: a crashed peer.  Stop reading; its silence ages out
        // through the same miss path a freeze takes.
        eofs[i] = true;
        continue;
      }
      size_t off = 0;
      while (bufs[i].size() - off >= kHeartbeatFrameBytes) {
        HeartbeatFrame in;
        if (ParseHeartbeat(bufs[i].data() + off, &in) &&
            static_cast<int64_t>(in.epoch) == ep) {
          if (in.magic == kSuspectMagic) {
            int s = static_cast<int>(in.seq);
            if (s >= 0 && s < cur_size_.load() && s != cur_rank_.load())
              flag(s);
          } else if (in.magic == kEchoMagic) {
            // Our own beacon, bounced back by the neighbour: one RTT
            // sample for the link this echo arrived on.
            int idx = static_cast<int>(in.seq & 0xffu);
            if (static_cast<int>(in.sender_rank) == cur_rank_.load() &&
                echo_seq[idx] == in.seq)
              NetLinkRecordRtt(cached_peers[i],
                               EpochNowUs() - echo_ts[idx]);
          } else {
            hb_recv_.fetch_add(1);
            int sender = static_cast<int>(in.sender_rank);
            {
              std::lock_guard<std::mutex> lk(hb_mu_);
              hb_last_seen_us_[sender] = EpochNowUs();
              hb_miss_counts_[sender] = 0;
            }
            // Bounce the beacon straight back with the magic swapped
            // (sender_rank/epoch/seq preserved) on the same full-duplex
            // socket — the sender turns it into the link's RTT estimate.
            HeartbeatFrame echo = in;
            echo.magic = kEchoMagic;
            uint8_t ef[kHeartbeatFrameBytes];
            SerializeHeartbeat(echo, ef);
            SendAll(cached_fds[i], ef, sizeof ef);
          }
        }
        off += kHeartbeatFrameBytes;
      }
      if (off > 0)
        bufs[i].erase(bufs[i].begin(),
                      bufs[i].begin() + static_cast<long>(off));
    }
  }
}

bool Engine::CheckHeartbeatLocalAbort() {
  if (!hb_local_abort_.load()) return false;
  std::string msg;
  {
    std::lock_guard<std::mutex> lk(hb_mu_);
    msg = hb_local_abort_msg_;
  }
  AbortLocal(ST_RANKS_DOWN, msg);
  return true;
}

void Engine::CoordinatorDrainHeartbeatDeaths() {
  if (!coord_) return;
  std::vector<int> dead;
  {
    std::lock_guard<std::mutex> lk(hb_mu_);
    if (pending_hb_dead_.empty()) return;
    dead.swap(pending_hb_dead_);
  }
  for (int r : dead) {
    if (r <= 0 || r >= opts_.size || coord_->rank_dead[r]) continue;
    hb_evictions_.fetch_add(1);
    MarkRankDead(r,
                 "no data-plane heartbeats at rank 0 for the miss window; "
                 "process frozen or link partitioned");
  }
}

bool Engine::SendHeartbeatReports(int fd) {
  std::vector<int> reports;
  {
    std::lock_guard<std::mutex> lk(hb_mu_);
    if (pending_hb_report_.empty()) return true;
    reports.swap(pending_hb_report_);
  }
  if (fd < 0) return true;
  RequestList rl;
  rl.membership_epoch = membership_epoch_.load();
  rl.hb_report = true;
  for (int r : reports) {
    rl.dead_ranks.push_back(r);
    if (flight_.Enabled()) flight_.Record(FL_HEARTBEAT_MISS, "report", r);
  }
  if (!SendFrame(fd, SerializeRequestList(rl))) return false;
  ctrl_frames_sent_.fetch_add(1);
  return true;
}

bool Engine::WaitParentSliced(int fd, double total_sec) {
  // total_sec < 0 means "no deadline" (collective timeout disabled).
  if (hb_interval_ms_ <= 0) {
    if (total_sec < 0) {
      while (!WaitReadable(fd, 3600.0)) {
      }
      return true;
    }
    return WaitReadable(fd, total_sec);
  }
  // Slice the blocking parent wait so the heartbeat escalation stays
  // live inside it: pending reports go up (the coordinator handles
  // out-of-band hb_report frames at any point in the alternation) and a
  // monitor-latched local abort breaks the wait immediately.
  auto deadline = std::chrono::steady_clock::now() +
                  std::chrono::duration<double>(total_sec);
  for (;;) {
    if (hb_local_abort_.load()) return false;
    SendHeartbeatReports(fd);
    double left =
        total_sec < 0 ? 0.05
                      : std::chrono::duration<double>(
                            deadline - std::chrono::steady_clock::now())
                            .count();
    if (left <= 0.0) return false;
    if (WaitReadable(fd, std::min(0.05, left))) return true;
  }
}

std::string Engine::LivenessInfo() {
  std::string out = std::to_string(hb_interval_ms_) + "|" +
                    std::to_string(hb_miss_limit_) + "|" +
                    std::to_string(hb_sent_.load()) + "|" +
                    std::to_string(hb_recv_.load()) + "|" +
                    std::to_string(hb_miss_events_.load()) + "|" +
                    std::to_string(hb_evictions_.load()) + "|" +
                    std::to_string(clock_fanin_.load()) + "|";
  std::lock_guard<std::mutex> lk(hb_mu_);
  std::vector<int> peers;
  for (const auto& kv : hb_last_seen_us_) peers.push_back(kv.first);
  std::sort(peers.begin(), peers.end());
  int64_t now = EpochNowUs();
  bool first = true;
  for (int p : peers) {
    if (!first) out += ' ';
    first = false;
    auto mit = hb_miss_counts_.find(p);
    out += std::to_string(p) + ":" +
           std::to_string(now - hb_last_seen_us_[p]) + ":" +
           std::to_string(mit == hb_miss_counts_.end() ? 0 : mit->second);
  }
  return out;
}

namespace {
// Verdict-kind names; index = the `kind` stored in AnomalyVerdict and
// the arg carried by the FL_ANOMALY flight event.
const char* const kAnomalyKinds[] = {"slow_link", "straggler",
                                     "cache_degraded", "slow_phase"};

double RobustMedian(std::vector<double> v) {
  if (v.empty()) return 0.0;
  std::sort(v.begin(), v.end());
  size_t n = v.size();
  return n % 2 ? v[n / 2] : 0.5 * (v[n / 2 - 1] + v[n / 2]);
}

double RobustMad(const std::vector<double>& v, double med) {
  std::vector<double> devs;
  devs.reserve(v.size());
  for (double x : v) devs.push_back(std::fabs(x - med));
  return RobustMedian(std::move(devs));
}
}  // namespace

std::string Engine::LinkInfo() { return NetLinkInfo(); }

void Engine::EmitAnomaly(int kind, const std::string& subject,
                         const std::string& detail) {
  std::string label = kAnomalyKinds[kind];
  if (!subject.empty()) label += "(" + subject + ")";
  {
    std::lock_guard<std::mutex> lk(anomaly_mu_);
    ++anomaly_counts_[kind];
    anomaly_log_.push_back({EpochNowUs(), kind, subject, detail});
    while (anomaly_log_.size() > 64) anomaly_log_.pop_front();
  }
  if (flight_.Enabled()) flight_.Record(FL_ANOMALY, label, kind);
  timeline_.Instant("hvd_anomaly", label);
}

std::string Engine::AnomalyInfo() {
  std::lock_guard<std::mutex> lk(anomaly_mu_);
  std::string out = std::to_string(anomaly_sigma_) + "|" +
                    std::to_string(anomaly_interval_ms_);
  for (int i = 0; i < 4; ++i)
    out += "|" + std::to_string(anomaly_counts_[i]);
  return out;
}

std::string Engine::AnomalyLog() {
  int64_t now = EpochNowUs();
  std::lock_guard<std::mutex> lk(anomaly_mu_);
  std::string out;
  for (const auto& v : anomaly_log_) {
    if (!out.empty()) out += ';';
    std::string subj, det;
    for (char c : v.subject) subj += (c == ';' || c == '|') ? '_' : c;
    for (char c : v.detail) det += (c == ';' || c == '|') ? '_' : c;
    out += std::string(kAnomalyKinds[v.kind]) + "|" + subj + "|" + det +
           "|" + std::to_string(now - v.ts_us);
  }
  return out;
}

void Engine::AnomalyLoop() {
  // Detector thread contract: all sweep state (windows, baselines,
  // episode flags) is thread-local to this function; the only shared
  // surfaces are atomics, the net.h link accessor, announce_mu_, and the
  // verdict sink (EmitAnomaly).  One verdict per episode: a flagged
  // subject re-arms only after a clean sweep.
  const int kSustain = 3;  // consecutive excursion sweeps before a verdict
  const double sigma = anomaly_sigma_;
  std::map<int, std::deque<double>> link_win;
  std::map<int, long long> link_sum, link_cnt;
  std::map<int, int> link_hot;
  std::set<int> link_flagged;
  std::vector<int64_t> ann_last;
  std::vector<int> ann_hot;
  std::set<int> ann_flagged;
  int64_t cache_hits_last = cache_hits_.load();
  int64_t cache_misses_last = cache_misses_.load();
  std::deque<double> cache_win;
  int cache_hot = 0;
  bool cache_flagged = false;
  const char* phase_names[3] = {"local_rs", "cross", "local_ag"};
  std::atomic<int64_t>* phase_src[3] = {&topo_rs_us_, &topo_cross_us_,
                                        &topo_ag_us_};
  int64_t phase_last[3] = {phase_src[0]->load(), phase_src[1]->load(),
                           phase_src[2]->load()};
  int64_t phase_ops_last = topo_timed_ops_.load();
  std::deque<double> phase_win[3];
  int phase_hot[3] = {0, 0, 0};
  bool phase_flagged[3] = {false, false, false};

  while (!anomaly_stop_.load()) {
    // Sliced nap: shutdown joins within ~10ms regardless of interval.
    for (int slept = 0;
         slept < anomaly_interval_ms_ && !anomaly_stop_.load(); slept += 10)
      std::this_thread::sleep_for(std::chrono::milliseconds(10));
    if (anomaly_stop_.load()) break;
    if (!initialized_.load()) continue;
    const int me = cur_rank_.load();

    // --- slow_link: CROSS-SECTIONAL robust baseline.  Each link's level
    // (median of its per-sweep delta-mean timed-send latencies) is
    // compared against the median + MAD across ALL this rank's links —
    // never against its own history — so a link that has been slow since
    // init (a chaos delay clause with no @after, or a genuinely bad DCN
    // route) still stands out.  Needs >= 3 links for the median to pin
    // the healthy level; a 2-link rank cannot localize anyway.
    for (const auto& lt : NetLinkLatencyTotals()) {
      long long dsum = lt.sum_us - link_sum[lt.peer];
      long long dcnt = lt.count - link_cnt[lt.peer];
      link_sum[lt.peer] = lt.sum_us;
      link_cnt[lt.peer] = lt.count;
      if (dcnt <= 0) continue;  // idle sweep: window keeps its level
      auto& w = link_win[lt.peer];
      w.push_back(static_cast<double>(dsum) / static_cast<double>(dcnt));
      while (w.size() > 16) w.pop_front();
    }
    std::vector<std::pair<int, double>> levels;
    for (const auto& kv : link_win)
      if (kv.second.size() >= 3)
        levels.emplace_back(
            kv.first, RobustMedian(std::vector<double>(kv.second.begin(),
                                                       kv.second.end())));
    if (levels.size() >= 3) {
      std::vector<double> ls;
      ls.reserve(levels.size());
      for (const auto& p : levels) ls.push_back(p.second);
      double med = RobustMedian(ls);
      // 200µs floor under the MAD: loopback/veth sends jitter by tens of
      // µs, and a near-zero MAD would turn that into false verdicts.
      double scale = std::max(RobustMad(ls, med), 200.0);
      for (const auto& p : levels) {
        bool hot = (p.second - med) / scale > sigma;
        int& streak = link_hot[p.first];
        streak = hot ? streak + 1 : 0;
        if (!hot) link_flagged.erase(p.first);
        if (streak >= kSustain && !link_flagged.count(p.first)) {
          link_flagged.insert(p.first);
          char det[128];
          snprintf(det, sizeof det,
                   "timed-send level %.0fus vs cross-link median %.0fus",
                   p.second, med);
          int lo = std::min(me, p.first), hi = std::max(me, p.first);
          EmitAnomaly(0, std::to_string(lo) + "-" + std::to_string(hi),
                      det);
        }
      }
    }

    // --- straggler (rank 0): a rank closing >= 75% of a sweep's
    // negotiations (the coordinator's exact last-to-announce counts)
    // across kSustain busy sweeps is the straggler — share-based rather
    // than sigma-based because with one bad rank the "population" of
    // closers is degenerate (median = the straggler).
    if (me == 0) {
      std::vector<int64_t> counts;
      {
        std::lock_guard<std::mutex> lk(announce_mu_);
        counts = last_announce_counts_;
      }
      if (ann_last.size() != counts.size()) {
        ann_last.assign(counts.size(), 0);
        ann_hot.assign(counts.size(), 0);
        ann_flagged.clear();
      }
      int64_t total = 0;
      std::vector<int64_t> delta(counts.size(), 0);
      for (size_t r = 0; r < counts.size(); ++r) {
        delta[r] = counts[r] - ann_last[r];
        total += delta[r];
        ann_last[r] = counts[r];
      }
      if (total >= 16) {
        for (size_t r = 0; r < counts.size(); ++r) {
          bool hot = delta[r] * 4 >= total * 3;
          ann_hot[r] = hot ? ann_hot[r] + 1 : 0;
          if (!hot) ann_flagged.erase(static_cast<int>(r));
          if (ann_hot[r] >= kSustain &&
              !ann_flagged.count(static_cast<int>(r))) {
            ann_flagged.insert(static_cast<int>(r));
            char det[96];
            snprintf(det, sizeof det,
                     "last to announce in %lld of %lld negotiations",
                     static_cast<long long>(delta[r]),
                     static_cast<long long>(total));
            EmitAnomaly(1, std::to_string(r), det);
          }
        }
      }
    }

    // --- cache_degraded: TEMPORAL baseline on the per-sweep hit rate
    // (degradation over time is the failure mode; the cold-start climb
    // can never fire it — early sweeps sit below no baseline).
    {
      int64_t h = cache_hits_.load(), m = cache_misses_.load();
      int64_t dh = h - cache_hits_last, dm = m - cache_misses_last;
      cache_hits_last = h;
      cache_misses_last = m;
      if (dh + dm >= 16) {
        double rate =
            static_cast<double>(dh) / static_cast<double>(dh + dm);
        if (cache_win.size() >= 6) {
          std::vector<double> v(cache_win.begin(), cache_win.end());
          double med = RobustMedian(v);
          bool hot =
              (med - rate) / std::max(RobustMad(v, med), 0.02) > sigma;
          cache_hot = hot ? cache_hot + 1 : 0;
          if (!hot) cache_flagged = false;
          if (cache_hot >= kSustain && !cache_flagged) {
            cache_flagged = true;
            char det[96];
            snprintf(det, sizeof det, "hit rate %.2f vs baseline %.2f",
                     rate, med);
            EmitAnomaly(2, "", det);
          }
        }
        cache_win.push_back(rate);
        while (cache_win.size() > 32) cache_win.pop_front();
      }
    }

    // --- slow_phase: temporal baselines on the two-level topology's
    // per-phase mean times (local reduce-scatter / cross-node / local
    // allgather) — localizes "the DCN hop got slow" separately from any
    // single link verdict.
    {
      int64_t ops = topo_timed_ops_.load();
      int64_t dops = ops - phase_ops_last;
      phase_ops_last = ops;
      for (int p = 0; p < 3; ++p) {
        int64_t s = phase_src[p]->load();
        int64_t ds = s - phase_last[p];
        phase_last[p] = s;
        if (dops <= 0) continue;
        double mean = static_cast<double>(ds) / static_cast<double>(dops);
        if (phase_win[p].size() >= 6) {
          std::vector<double> v(phase_win[p].begin(), phase_win[p].end());
          double med = RobustMedian(v);
          bool hot =
              (mean - med) / std::max(RobustMad(v, med), 100.0) > sigma;
          phase_hot[p] = hot ? phase_hot[p] + 1 : 0;
          if (!hot) phase_flagged[p] = false;
          if (phase_hot[p] >= kSustain && !phase_flagged[p]) {
            phase_flagged[p] = true;
            char det[96];
            snprintf(det, sizeof det,
                     "phase mean %.0fus vs baseline %.0fus", mean, med);
            EmitAnomaly(3, phase_names[p], det);
          }
        }
        phase_win[p].push_back(mean);
        while (phase_win[p].size() > 32) phase_win[p].pop_front();
      }
    }
  }
}

void Engine::BackgroundLoop() {
  while (RunLoopOnce()) {
  }
  // Drain: fail everything still pending so blocked Wait() calls return
  // (the reference's SHUT_DOWN_ERROR drain on loop exit,
  // operations.cc:1446-1461).  loop_exited_ flips under mu_ so a racing
  // Enqueue either lands before the drain (and is failed here) or observes
  // the flag and is rejected.
  std::vector<TableEntry> leftovers;
  {
    std::lock_guard<std::mutex> lk(mu_);
    loop_exited_.store(true);
    for (auto& kv : table_) leftovers.push_back(kv.second);
    table_.clear();
    queue_.clear();
  }
  // A coordinated abort poisons the drain with its structured status
  // (ST_RANKS_DOWN / ST_TIMEOUT naming the missing ranks or stalled
  // tensors); a clean shutdown keeps the generic ST_ABORTED message.
  int32_t code = abort_code_.load();
  std::string msg;
  if (code != 0) {
    std::lock_guard<std::mutex> lk(abort_mu_);
    msg = abort_message_;
  } else {
    code = ST_ABORTED;
    msg = "Horovod-TPU has been shut down. This was caused by an "
          "exception on one of the ranks or an earlier shutdown.";
  }
  for (auto& e : leftovers) CompleteEntry(e, code, msg);
  // Post-mortem traces must survive even if the process exits without
  // reaching Shutdown() (docs/timeline.md): the loop exit — abort paths
  // included — leaves the file parseable on disk.
  timeline_.Flush();
}

int64_t Engine::Enqueue(uint8_t op, const std::string& name, const void* in,
                        void* out, const std::vector<int64_t>& dims,
                        uint8_t dtype, int root_rank, bool average, int peer,
                        int tag, const std::vector<int32_t>& stage_ranks) {
  if (!initialized_.load()) return -1;
  auto status = std::make_shared<HandleStatus>();
  int64_t handle = next_handle_.fetch_add(1);
  {
    std::lock_guard<std::mutex> lk(handles_mu_);
    handles_[handle] = status;
  }
  // Preconditions the coordinator could only report a tick later: a p2p
  // op needs a real counterpart, and stage groups only scope allreduce.
  if (op == OP_SEND || op == OP_RECV) {
    if (peer < 0 || peer >= size() || peer == rank()) {
      status->error = std::string(OpName(op)) + " '" + name +
                      "' names peer rank " + std::to_string(peer) +
                      ", which is not another rank of this " +
                      std::to_string(size()) + "-rank job.";
      status->code.store(ST_PRECONDITION);
      return handle;
    }
  } else if (!stage_ranks.empty()) {
    bool member = false;
    bool in_range = true;
    for (int32_t m : stage_ranks) {
      if (m == rank()) member = true;
      if (m < 0 || m >= size()) in_range = false;
    }
    if (op != OP_ALLREDUCE || !member || !in_range ||
        stage_ranks.size() < 2) {
      status->error =
          "stage-group collectives support allreduce among >= 2 valid "
          "member ranks including the caller; '" +
          name + "' violates that (op " + OpName(op) + ", " +
          std::to_string(stage_ranks.size()) + " members).";
      status->code.store(ST_PRECONDITION);
      return handle;
    }
  }
  TableEntry e;
  e.name = name;
  e.op = op;
  e.dtype = dtype;
  e.dims = dims;
  e.in = in;
  e.out = out;
  e.root_rank = root_rank;
  e.average = average;
  e.p2p_peer = peer;
  e.p2p_tag = tag;
  e.stage_ranks = stage_ranks;
  e.handle = handle;
  e.enqueued_at = std::chrono::steady_clock::now();
  {
    std::lock_guard<std::mutex> lk(mu_);
    // Failure paths need no notify: the handle has not been returned to
    // the caller yet, so no waiter can exist; Wait's predicate check sees
    // the already-flipped (atomic) code.
    if (loop_exited_.load()) {
      int32_t code = abort_code_.load();
      if (code != 0) {
        std::lock_guard<std::mutex> alk(abort_mu_);
        status->error = abort_message_;
      } else {
        code = ST_ABORTED;
        status->error =
            "Horovod-TPU has been shut down; no further collectives can run.";
      }
      status->code.store(code);
      return handle;
    }
    if (reshape_ack_pending_.load()) {
      // Elastic reshape not yet acknowledged: fail fast with the
      // retryable status instead of letting this op stall a negotiation
      // its peers are not running (they are resyncing state).  Checked
      // under mu_ so it pairs exactly with ApplyReshape's drain.
      std::lock_guard<std::mutex> mlk(membership_mu_);
      status->error = reshape_message_;
      status->code.store(ST_RESHAPE);
      return handle;
    }
    if (table_.count(name)) {
      // Same duplicate-name precondition as the reference enqueue
      // (operations.cc:1827-1833).
      status->error = "A collective with name '" + name +
                      "' is already in progress; names must be unique per "
                      "outstanding operation.";
      status->code.store(ST_PRECONDITION);
      return handle;
    }
    table_.emplace(name, std::move(e));
    if (flight_.Enabled()) flight_.Record(FL_ENQUEUE, name, handle);
    Request req;
    req.rank = opts_.rank;
    req.op = op;
    req.dtype = dtype;
    req.root_rank = root_rank;
    req.name = name;
    req.dims = dims;
    req.p2p_peer = peer;
    req.p2p_tag = tag;
    req.stage_ranks = stage_ranks;
    queue_.push_back(std::move(req));
  }
  // Wake a steady-state idle wait (no-op otherwise: nothing waits on
  // this cv while the per-tick frame protocol paces the loop).
  queue_cv_.notify_one();
  return handle;
}

// ---------------------------------------------------------------------------
// Negotiation tick.
// ---------------------------------------------------------------------------

namespace {

// Per-aggregate slot -> bit_groups index, threaded through the merge so
// the per-tick fold stays linear in announced bits (a plain scan made
// the sub-coordinator's fold quadratic in distinct slots — wasted work
// on exactly the path this tree exists to flatten).
using SlotIndex = std::unordered_map<uint32_t, size_t>;

// Fold one rank's cache-bit announcement into an aggregate's per-slot
// groups (docs/performance.md#control-plane-scaling).
void AddBitToGroups(RequestList* agg, SlotIndex* idx, uint32_t slot,
                    int rank, int64_t ts) {
  auto it = idx->find(slot);
  if (it == idx->end())
    it = idx->emplace(slot, agg->bit_groups.size()).first;
  if (it->second == agg->bit_groups.size()) {
    BitGroup g;
    g.slot = slot;
    agg->bit_groups.push_back(std::move(g));
  }
  BitGroup& g = agg->bit_groups[it->second];
  g.ranks.push_back(rank);
  g.announce_us.push_back(ts);
}

// Fold one per-rank frame (the sub-coordinator's own, or a leaf child's)
// into the aggregate forwarded to rank 0.  `ts` is the announce time on
// rank 0's clock for entries that carry none of their own.
void MergeFrameIntoAggregate(const RequestList& frame, int rank, int64_t ts,
                             RequestList* agg, SlotIndex* idx) {
  agg->shutdown = agg->shutdown || frame.shutdown;
  for (size_t i = 0; i < frame.requests.size(); ++i) {
    agg->requests.push_back(frame.requests[i]);
    agg->announce_us.push_back(
        i < frame.announce_us.size() && frame.announce_us[i] >= 0
            ? frame.announce_us[i]
            : ts);
  }
  for (uint32_t bit : frame.cache_bits)
    AddBitToGroups(agg, idx, bit, rank, ts);
  for (const auto& g : frame.bit_groups)
    for (size_t j = 0; j < g.ranks.size(); ++j)
      AddBitToGroups(agg, idx, g.slot, g.ranks[j],
                     j < g.announce_us.size() ? g.announce_us[j] : ts);
  agg->frames_from.push_back(rank);
  for (int32_t r : frame.frames_from) agg->frames_from.push_back(r);
  for (int32_t r : frame.dead_ranks) agg->dead_ranks.push_back(r);
  if (frame.steady_exit) agg->steady_exits.push_back(rank);
  for (int32_t r : frame.steady_exits) agg->steady_exits.push_back(r);
}

}  // namespace

bool Engine::RunLoopOnce() {
  auto tick_start = std::chrono::steady_clock::now();

  // Monitor-latched partition verdict: surface it before anything else
  // touches a socket this pass.
  if (CheckHeartbeatLocalAbort()) return false;

  // Reclaim the fusion buffer after a sustained idle stretch (it
  // previously only ever grew, pinning its high-water mark for the life
  // of the process): a burst of big fused allreduces no longer holds tens
  // of MB through hours of, say, evaluation-only phases.
  if (!fusion_buffer_.empty() &&
      tick_start - last_fusion_use_ > std::chrono::seconds(10)) {
    std::vector<char>().swap(fusion_buffer_);
  }

  // Decentralized steady state (docs/performance.md
  // #control-plane-scaling): the control plane is dark; replay the
  // broadcast pattern self-clocked with zero frames per cycle.
  if (steady_active_.load()) return SteadyLoopOnce();

  RequestList my_requests;
  my_requests.shutdown = shut_down_.load();
  // Frames are epoch-stamped so the coordinator can reject one built
  // against a previous membership (wire.h RequestList.membership_epoch).
  my_requests.membership_epoch = membership_epoch_.load();
  if (steady_exit_pending_) {
    // First frame after a steady exit carries the fallback marker (and
    // the miss position, for postmortem dumps): rank 0 resumes
    // broadcasting only once every rank has sent one of these.
    my_requests.steady_exit = 1;
    my_requests.steady_epoch = steady_exit_epoch_;
    my_requests.steady_pos = steady_exit_pos_;
    // hvdlint: lockstep-ok(one-shot send latch set by ExitSteadyLocal)
    steady_exit_pending_ = false;
  }
  {
    std::lock_guard<std::mutex> lk(mu_);
    while (!queue_.empty()) {
      Request req = std::move(queue_.front());
      queue_.pop_front();
      // Response-cache fast path: a signature-identical repeat announces
      // its slot index; everything else (first occurrence, or a changed
      // shape/dtype/root — the fallback that keeps the mismatch
      // validation live) goes out as a full string request.
      int slot = cache_.enabled() ? cache_.Lookup(req) : -1;
      if (slot >= 0) {
        my_requests.cache_bits.push_back(static_cast<uint32_t>(slot));
        cache_hits_.fetch_add(1);
        if (flight_.Enabled()) flight_.Record(FL_CACHE_HIT, req.name, slot);
      } else {
        if (cache_.enabled()) cache_misses_.fetch_add(1);
        if (flight_.Enabled()) flight_.Record(FL_ANNOUNCE, req.name, 0);
        my_requests.requests.push_back(std::move(req));
      }
    }
  }

  ResponseList responses;
  if (opts_.rank == 0) {
    // Coordinator (covers the single-process case too: the worker loop
    // and broadcast below are empty at size 1, but joiner admission and
    // reshape barriers must still run — a job shrunk to one rank keeps
    // accepting standbys).
    CoordinatorAcceptJoiners();
    CoordinatorDrainHeartbeatDeaths();
    coord_->shutdown_requested |= my_requests.shutdown;
    if (my_requests.steady_exit) NoteSteadyExit(0);
    CoordinatorHandle(my_requests, 0);
    if (coord_->steady) {
      // Post-steady holding pattern: some ranks may still be
      // self-clocking with their control sockets dark, so (a) expect no
      // per-tick frames — poll instead of the blocking liveness recv,
      // and (b) broadcast NOTHING (beyond abort/shutdown, which the poll
      // handles) until every rank has fallen back, or ranks still
      // replaying would double-execute the ops a broadcast list carries.
      if (!CoordinatorSteadyPoll()) return false;
      {
        int rv = MaybeRevokeSteadyForReshape();
        if (rv < 0) return false;
        if (rv > 0) return true;  // revoked: next pass is a normal tick
      }
      if (!AllSteadyExited()) {
        UpdateCoordPendingInfo();
        std::this_thread::sleep_for(std::chrono::microseconds(200));
        return true;
      }
      coord_->steady = false;
      coord_->steady_revoke_next = true;
      coord_->slot_history.clear();
      // Fall through: THIS pass builds and broadcasts the resume list —
      // frames already polled above, so skip the per-child recv loop.
    } else {
      // One frame per live child per tick, collected in ARRIVAL order:
      // a frozen child must not head-of-line-block its healthy siblings,
      // whose frames (and heartbeat reports) are exactly what lets the
      // sweep mark the frozen one dead in O(heartbeat) rather than its
      // own O(collective-timeout) deadline.
      //
      // Liveness: a healthy child's engine thread sends a frame every
      // cycle (~5ms), so with a hard deadline configured, a deadline of
      // control-plane silence means the child PROCESS is frozen
      // (SIGSTOP, OOM thrash) or partitioned — a state socket EOF never
      // reports.  A healthy sub-coordinator may itself block up to one
      // deadline probing a frozen LEAF before its aggregate (naming the
      // true dead rank) goes out — it gets the same widened bound the
      // workers give the coordinator, or rank 0 would misattribute a
      // leaf freeze to the whole node.
      std::vector<int> waiting;
      for (int r : coord_children_)
        if (!coord_->rank_dead[r]) waiting.push_back(r);
      auto sweep_start = std::chrono::steady_clock::now();
      const double T = opts_.collective_timeout_sec;
      while (!waiting.empty()) {
        CoordinatorDrainHeartbeatDeaths();
        for (size_t i = 0; i < waiting.size();)
          if (coord_->rank_dead[waiting[i]])
            waiting.erase(waiting.begin() + i);
          else
            ++i;
        bool progressed = false;
        for (size_t i = 0; i < waiting.size();) {
          int r = waiting[i];
          int fd = coord_fds_[r];
          bool sub_lead = tree_enabled_ && r >= opts_.local_size;
          bool consumed_tick = false, lost = false;
          while (WaitReadable(fd, 0.0)) {
            std::vector<uint8_t> buf;
            if (!RecvFrame(fd, &buf)) {
              // A child died (control-socket EOF): escalate to a
              // coordinated ABORT naming the missing rank and the
              // tensors it left pending (sharpens the reference's
              // SHUT_DOWN_ERROR path, operations.cc:1579-1605, into a
              // structured status).
              MarkRankDead(r, sub_lead
                                  ? "sub-coordinator connection lost "
                                    "(its node is unreachable)"
                                  : "connection lost at the coordinator");
              lost = true;
              break;
            }
            ctrl_frames_recv_.fetch_add(1);
            RequestList rl;
            if (!ParseRequestList(buf, &rl)) continue;
            coord_->last_frame_tick[r] = ticks_done_.load();
            coord_->shutdown_requested |= rl.shutdown;
            CoordinatorHandle(rl, r);
            // Out-of-band heartbeat reports ride BETWEEN tick frames
            // (wire.h RequestList.hb_report); keep waiting for the
            // child's real frame.
            if (rl.hb_report) continue;
            consumed_tick = true;
            break;
          }
          if (consumed_tick || lost) {
            waiting.erase(waiting.begin() + i);
            progressed = true;
          } else {
            ++i;
          }
        }
        if (waiting.empty() || progressed) continue;
        double waited = std::chrono::duration<double>(
                            std::chrono::steady_clock::now() - sweep_start)
                            .count();
        if (T > 0) {
          bool timed_out = false;
          for (size_t i = 0; i < waiting.size();) {
            int r = waiting[i];
            bool sub_lead = tree_enabled_ && r >= opts_.local_size;
            if (waited > (sub_lead ? 2 * T + 5.0 : T)) {
              char why[112];
              snprintf(why, sizeof(why),
                       "no control-plane traffic for %.0fs; %s frozen or "
                       "network partitioned",
                       T, sub_lead ? "sub-coordinator" : "process");
              MarkRankDead(r, why);
              waiting.erase(waiting.begin() + i);
              timed_out = true;
            } else {
              ++i;
            }
          }
          if (timed_out) continue;
        }
        // Nothing ready and nobody over deadline: block on the first
        // straggler, sliced so heartbeat deaths and other children's
        // frames keep getting service.
        double slice = hb_interval_ms_ > 0 ? 0.05 : 1.0;
        if (T > 0) {
          bool first_sub =
              tree_enabled_ && waiting[0] >= opts_.local_size;
          double left = (first_sub ? 2 * T + 5.0 : T) - waited;
          if (left < slice) slice = std::max(left, 0.001);
        }
        WaitReadable(coord_fds_[waiting[0]], slice);
      }
    }
    CheckCollectiveTimeout();
    responses = CoordinatorTick();
    AttachTunedParams(&responses);
    CoordinatorMaybeReshape(&responses);
    CoordinatorMaybeSteady(&responses);
    if (coord_->steady_revoke_next && responses.abort_code == 0) {
      responses.steady_revoke = true;
      coord_->steady_revoke_next = false;
    }
    UpdateCoordPendingInfo();
    if (opts_.size > 1 || responses.reshape_present) {
      std::vector<uint8_t> out = SerializeResponseList(responses);
      for (int r : coord_children_) {
        if (coord_->rank_dead[r]) continue;
        if (SendFrame(coord_fds_[r], out)) ctrl_frames_sent_.fetch_add(1);
      }
      // Admitted standbys receive the same barrier frame over the control
      // socket they registered on; ApplyReshape below then folds their
      // fds into the coordinator star.
      if (responses.reshape_present)
        for (int fd : coord_->pending_join_fds) SendFrame(fd, out);
    }
  } else if (is_sub_coord_) {
    if (sub_holding_) {
      // Between this sub-coordinator's own steady exit and the next
      // parent broadcast: children may still be self-clocking, so never
      // block on them — forward own announcements upward as they drain,
      // keep relaying children's fallback frames, and let SubRelayPass
      // consume the resume broadcast.
      if (!my_requests.requests.empty() || !my_requests.cache_bits.empty() ||
          my_requests.steady_exit || my_requests.shutdown) {
        RequestList agg;
        SlotIndex idx;
        agg.membership_epoch = membership_epoch_.load();
        MergeFrameIntoAggregate(my_requests, opts_.rank,
                                EpochNowUs() - clock_offset_us_.load(),
                                &agg, &idx);
        if (!SendFrame(coord_fd_, SerializeRequestList(agg))) {
          AbortLocal(ST_RANKS_DOWN,
                     "ranks down: 0 (coordinator connection lost); this "
                     "job cannot continue and should be restarted.");
          return false;
        }
        ctrl_frames_sent_.fetch_add(1);
      }
      if (!SubRelayPass()) return false;
      std::this_thread::sleep_for(std::chrono::microseconds(200));
      return true;
    }
    // Strict per-tick aggregation: one frame from each live child, one
    // aggregate up, one broadcast down (relayed raw before local
    // processing — the sub's own data-plane execution blocks on its
    // children's participation).
    RequestList agg;
    SlotIndex idx;
    agg.membership_epoch = membership_epoch_.load();
    MergeFrameIntoAggregate(my_requests, opts_.rank,
                            EpochNowUs() - clock_offset_us_.load(), &agg,
                            &idx);
    // This sub's own monitor flags ride up inside the aggregate's
    // dead_ranks (the pending_dead_reports_ flush below), exactly like a
    // child EOF it observed.
    {
      std::lock_guard<std::mutex> lk(hb_mu_);
      for (int r : pending_hb_report_) pending_dead_reports_.push_back(r);
      pending_hb_report_.clear();
    }
    for (size_t i = 0; i < tree_child_fds_.size(); ++i) {
      if (tree_child_dead_[i]) continue;
      int fd = tree_child_fds_[i];
      int crank = tree_child_ranks_[i];
      // Sliced child wait: a child's out-of-band heartbeat report must
      // relay upward (and this sub's own local-abort latch must fire)
      // without waiting out a frozen leaf's full deadline.
      auto child_start = std::chrono::steady_clock::now();
      const double T = opts_.collective_timeout_sec;
      for (;;) {
        if (WaitReadable(fd, hb_interval_ms_ > 0 ? 0.05 : (T > 0 ? T : 1.0))) {
          std::vector<uint8_t> buf;
          if (!RecvFrame(fd, &buf)) {
            tree_child_dead_[i] = true;
            agg.dead_ranks.push_back(crank);
            break;
          }
          ctrl_frames_recv_.fetch_add(1);
          RequestList child;
          if (!ParseRequestList(buf, &child)) continue;
          if (child.hb_report) {
            // Relay the report's dead_ranks in this tick's aggregate and
            // keep waiting for the child's real frame.
            for (int32_t r : child.dead_ranks) agg.dead_ranks.push_back(r);
            continue;
          }
          NoteChildSteadyExit(child, crank);
          MergeFrameIntoAggregate(child, crank,
                                  EpochNowUs() - clock_offset_us_.load(),
                                  &agg, &idx);
          break;
        }
        if (hb_local_abort_.load()) break;  // surfaced next pass
        double waited = std::chrono::duration<double>(
                            std::chrono::steady_clock::now() - child_start)
                            .count();
        if (T > 0 && waited > T) {
          tree_child_dead_[i] = true;
          agg.dead_ranks.push_back(crank);
          break;
        }
      }
    }
    for (int32_t r : pending_dead_reports_) agg.dead_ranks.push_back(r);
    pending_dead_reports_.clear();
    if (!SendFrame(coord_fd_, SerializeRequestList(agg))) {
      responses.abort_code = ST_RANKS_DOWN;
      responses.abort_message =
          "ranks down: 0 (coordinator connection lost); this job cannot "
          "continue and should be restarted.";
    } else {
      ctrl_frames_sent_.fetch_add(1);
      bool alive = opts_.collective_timeout_sec <= 0
                       ? WaitParentSliced(coord_fd_, -1.0)
                       : WaitParentSliced(coord_fd_, ParentWaitSec());
      std::vector<uint8_t> buf;
      if (!alive) {
        if (CheckHeartbeatLocalAbort()) return false;
        responses.abort_code = ST_RANKS_DOWN;
        responses.abort_message =
            "ranks down: 0 (coordinator unresponsive: no control-plane "
            "traffic within the deadline; process frozen or network "
            "partitioned); this job cannot continue and should be "
            "restarted.";
      } else if (!RecvFrame(coord_fd_, &buf) ||
                 !ParseResponseList(buf, &responses)) {
        if (CheckHeartbeatLocalAbort()) return false;
        responses.abort_code = ST_RANKS_DOWN;
        responses.abort_message =
            "ranks down: 0 (coordinator connection lost); this job cannot "
            "continue and should be restarted.";
      } else {
        ctrl_frames_recv_.fetch_add(1);
        for (size_t i = 0; i < tree_child_fds_.size(); ++i)
          if (!tree_child_dead_[i] && SendFrame(tree_child_fds_[i], buf))
            ctrl_frames_sent_.fetch_add(1);
      }
    }
  } else {
    // Out-of-band heartbeat reports ride ahead of this tick's frame, so
    // the send-one-wait-one alternation with the coordinator holds.
    SendHeartbeatReports(coord_fd_);
    if (!SendFrame(coord_fd_, SerializeRequestList(my_requests))) {
      if (CheckHeartbeatLocalAbort()) return false;
      responses.abort_code = ST_RANKS_DOWN;
      responses.abort_message =
          "ranks down: 0 (coordinator connection lost); this job cannot "
          "continue and should be restarted.";
    } else {
      ctrl_frames_sent_.fetch_add(1);
      // Bound the response wait too: 2x the deadline plus slack, because
      // a healthy coordinator may itself block up to one deadline probing
      // a frozen THIRD rank before it aborts and responds.
      bool alive = opts_.collective_timeout_sec <= 0
                       ? WaitParentSliced(coord_fd_, -1.0)
                       : WaitParentSliced(coord_fd_, ParentWaitSec());
      std::vector<uint8_t> buf;
      if (!alive) {
        if (CheckHeartbeatLocalAbort()) return false;
        responses.abort_code = ST_RANKS_DOWN;
        responses.abort_message =
            "ranks down: 0 (coordinator unresponsive: no control-plane "
            "traffic within the deadline; process frozen or network "
            "partitioned); this job cannot continue and should be "
            "restarted.";
      } else if (!RecvFrame(coord_fd_, &buf) ||
                 !ParseResponseList(buf, &responses)) {
        if (CheckHeartbeatLocalAbort()) return false;
        responses.abort_code = ST_RANKS_DOWN;
        responses.abort_message =
            "ranks down: 0 (coordinator connection lost); this job cannot "
            "continue and should be restarted.";
      } else {
        ctrl_frames_recv_.fetch_add(1);
      }
    }
  }
  return ProcessResponseList(responses, my_requests, tick_start);
}

bool Engine::ProcessResponseList(
    ResponseList& responses, const RequestList& my_requests,
    std::chrono::steady_clock::time_point tick_start) {
  // Elastic reshape barrier: the list carries no op payload (the
  // coordinator cleared it), so adopting the membership IS this tick's
  // work.  A rebuild failure latched a local abort — exit and drain.
  if (responses.reshape_present && !ApplyReshape(responses)) return false;
  // Tuned parameters apply BEFORE this tick's cache-hit replay: the
  // replay re-fuses under opts_.fusion_threshold, and every rank
  // processes this same list at this same tick index, so fusion-plan
  // changes land at one lockstep boundary instead of splitting the job
  // into old-threshold and new-threshold camps.
  if (responses.tuned_present) ApplyTunedParams(responses);
  ProcessCacheHits(responses.cache_hits);
  for (const auto& resp : responses.responses) PerformOperation(resp);
  // The response list (identical on every rank) is fully processed: close
  // the tick.  Completions stamped with tick t are all visible once
  // ticks_done_ > t, on every rank.
  ticks_done_.fetch_add(1);
  if (!responses.responses.empty() || !responses.cache_hits.empty())
    negotiated_ticks_.fetch_add(1);

  if (opts_.rank == 0) CheckForStalledTensors();

  if (responses.abort_code != 0) {
    // Coordinated abort: latch the structured status, then exit the loop;
    // the BackgroundLoop drain fails everything still pending with it.
    AbortLocal(responses.abort_code, responses.abort_message);
    return false;
  }
  if (responses.shutdown) return false;
  if (responses.steady_present) {
    // Arm self-clocked replay AFTER this list's hits replayed: every
    // rank processed the identical list, so every rank starts the
    // pattern at position 0 of the same cycle boundary.
    ApplySteady(responses);
    return true;
  }

  // Adaptive tick (docs/performance.md): with requests PENDING, the
  // fixed cycle sleep — not the negotiation itself — dominated latency
  // (a bit-vector agreement costs ~µs, the sleep ~5ms per round, and a
  // skewed multi-round negotiation paid it per ROUND on every rank).
  // While work flows — this tick announced requests or carried
  // responses — tick again immediately; the control-plane frame round
  // trip itself paces the loop.  With work outstanding but nothing
  // moving, run a bounded number of fast ticks (a multi-tick negotiation
  // finishing) before falling back to the configured cycle, so a
  // genuinely missing peer cannot spin the control plane at full speed.
  // Fully idle, take ONE cycle-length sleep (no fine-grained polling — an
  // idle fleet must not wake 5000x/s): fresh enqueues deliberately wait
  // for the cycle boundary, because the remainder of the cycle is the
  // CO-ARRIVAL window that lets an enqueue-all-then-wait group land in
  // one negotiation round and fuse into one ring pass (tests pin this).
  // HVD_TPU_CYCLE_TIME_MS therefore trades fusion window against
  // first-announce latency; once announced, rounds run at wire speed.
  const auto kPollSlice = std::chrono::microseconds(200);
  const int kMaxFastTicks = 64;
  bool flowed = !my_requests.requests.empty() ||
                !my_requests.cache_bits.empty() ||
                !responses.responses.empty() || !responses.cache_hits.empty();
  // Flight: stamp ticks that moved work (an idle fleet must not roll the
  // ring with thousands of empty ticks — the interesting final seconds
  // would be overwritten by silence).
  if (flowed && flight_.Enabled())
    flight_.Record(FL_TICK, "", ticks_done_.load());
  bool outstanding;
  {
    std::lock_guard<std::mutex> lk(mu_);
    outstanding = !queue_.empty() || !table_.empty();
  }
  if (coord_ && (opts_.rank == 0 || opts_.size == 1))
    outstanding = outstanding || !coord_->message_table.empty() ||
                  !coord_->cache_pending.empty();
  if (flowed) {
    fast_ticks_ = 0;
    return true;
  }
  if (outstanding && fast_ticks_ < kMaxFastTicks) {
    ++fast_ticks_;
    std::this_thread::sleep_for(kPollSlice);
    return true;
  }
  fast_ticks_ = 0;
  auto cycle = std::chrono::duration<double, std::milli>(opts_.cycle_time_ms);
  auto elapsed = std::chrono::steady_clock::now() - tick_start;
  if (elapsed < cycle)
    std::this_thread::sleep_for(cycle - elapsed);
  return true;
}

// ---------------------------------------------------------------------------
// Decentralized steady state (docs/performance.md#control-plane-scaling).
//
// The response cache made repeats cheap (a few bytes per op); this
// makes them FREE: once the coordinator observes the cache-hit slot
// stream repeat an identical cycle HVD_TPU_STEADY_THRESHOLD times at
// quiesced boundaries, it broadcasts the pattern and every rank
// self-clocks on an epoch counter, replaying the stored responses with
// zero control-plane frames per cycle.  Any miss (signature change, new
// tensor, shutdown) falls back to full negotiation; the signature-change
// revocation points all flow through the normal lockstep machinery once
// every rank has fallen back.
// ---------------------------------------------------------------------------

namespace {

// Smallest period P of `w` in the sliding-window sense (w[i] == w[i-P]
// for all i >= P), via the KMP prefix function.  O(|w|).
size_t SmallestPeriod(const std::vector<uint32_t>& w) {
  if (w.empty()) return 0;
  std::vector<size_t> pi(w.size(), 0);
  for (size_t i = 1; i < w.size(); ++i) {
    size_t k = pi[i - 1];
    while (k > 0 && w[i] != w[k]) k = pi[k - 1];
    if (w[i] == w[k]) ++k;
    pi[i] = k;
  }
  return w.size() - pi.back();
}

}  // namespace

void Engine::CoordinatorMaybeSteady(ResponseList* out) {
  if (!coord_ || opts_.steady_threshold <= 0) return;
  // Any non-pure-hit broadcast resets the detector: the window must
  // contain nothing but the steady-state hit stream, so a pattern found
  // in it is a pattern of the WHOLE control plane, not a lull between
  // fresh negotiations.
  if (out->abort_code != 0 || out->shutdown || out->reshape_present ||
      out->tuned_present || !out->responses.empty()) {
    coord_->slot_history.clear();
    return;
  }
  if (out->cache_hits.empty()) return;  // idle ticks are neutral
  for (size_t i = 0; i < out->cache_hits.size(); ++i)
    coord_->slot_history.emplace_back(out->cache_hits[i], i == 0);
  const size_t cap = static_cast<size_t>(opts_.steady_threshold) *
                         static_cast<size_t>(opts_.steady_max_period) +
                     static_cast<size_t>(opts_.steady_max_period);
  while (coord_->slot_history.size() > cap) coord_->slot_history.pop_front();
  // Eligibility: a quiesced cycle boundary with every lockstep mutation
  // source at rest.  The autotune search must be frozen (a tuned-param
  // broadcast cannot reach ranks whose control sockets are dark); an
  // elastic job may arm too — a barrier arming mid-steady goes out as a
  // revocation broadcast first (MaybeRevokeSteadyForReshape), so dark
  // sockets never strand a reshape.
  if (coord_->steady || opts_.size <= 1 || !cache_.enabled() ||
      tuner_.active() || !coord_->message_table.empty() ||
      !coord_->cache_pending.empty() ||
      !coord_->pending_join_fds.empty() || !coord_->handshaking.empty() ||
      reshape_ack_pending_.load())
    return;
  std::vector<uint32_t> w;
  std::vector<bool> starts;
  w.reserve(coord_->slot_history.size());
  for (const auto& e : coord_->slot_history) {
    w.push_back(e.first);
    starts.push_back(e.second);
  }
  size_t P = SmallestPeriod(w);
  if (P == 0 || P > static_cast<size_t>(opts_.steady_max_period)) return;
  if (w.size() < static_cast<size_t>(opts_.steady_threshold) * P) return;
  // The window must END at a cycle boundary by construction (cycles are
  // periodic), and the final cycle must START at a broadcast-list
  // boundary so the observed per-tick grouping cuts cleanly into replay
  // groups.
  size_t base = w.size() - P;
  if (!starts[base]) return;
  std::vector<uint32_t> pattern(w.begin() + base, w.end());
  // Patterns that include the XLA plane's "__xp." metadata agreements
  // never arm: the plane's dispatch-ordering contract waits on tick
  // closure, which self-clocked cycles advance only per wrap — the plane
  // already has its own zero-roundtrip replay.
  for (uint32_t slot : pattern) {
    const CacheSlot* s = cache_.Get(static_cast<int>(slot));
    if (s == nullptr || s->name.compare(0, 5, "__xp.") == 0) return;
  }
  std::vector<uint32_t> groups;
  for (size_t i = base; i < w.size(); ++i) {
    if (starts[i])
      groups.push_back(1);
    else
      ++groups.back();
  }
  out->steady_present = true;
  out->steady_pattern = std::move(pattern);
  out->steady_groups = std::move(groups);
  coord_->steady = true;
  coord_->steady_exited.assign(opts_.size, false);
  coord_->slot_history.clear();
}

void Engine::ApplySteady(const ResponseList& rl) {
  steady_pattern_ = rl.steady_pattern;
  steady_groups_.assign(rl.steady_groups.begin(), rl.steady_groups.end());
  // Defensive: groups must tile the pattern exactly; fall back to
  // per-slot groups (always safe — every rank received the same list,
  // so every rank falls back identically).
  uint64_t total = 0;
  for (uint32_t g : steady_groups_) total += g;
  if (steady_groups_.empty() || total != steady_pattern_.size())
    steady_groups_.assign(steady_pattern_.size(), 1);
  steady_pos_ = 0;
  steady_group_idx_ = 0;
  steady_epoch_ = 0;
  steady_idle_passes_ = 0;
  steady_last_poll_ = std::chrono::steady_clock::now();
  steady_pending_group_.clear();
  steady_pending_reqs_.clear();
  steady_exit_pending_ = false;
  steady_pattern_len_.store(static_cast<int64_t>(steady_pattern_.size()));
  steady_active_.store(true);
  steady_entries_.fetch_add(1);
  if (flight_.Enabled())
    flight_.Record(FL_STEADY, "enter",
                   static_cast<int64_t>(steady_pattern_.size()));
  timeline_.Instant("steady", "STEADY_ENTER");
}

void Engine::ExitSteadyLocal(const std::string& reason) {
  if (!steady_active_.load()) return;
  steady_active_.store(false);
  steady_exits_.fetch_add(1);
  steady_exit_pending_ = true;
  steady_exit_epoch_ = steady_epoch_;
  steady_exit_pos_ = static_cast<int64_t>(steady_pos_);
  steady_pattern_len_.store(0);
  if (is_sub_coord_) sub_holding_ = true;
  if (opts_.rank == 0 && coord_) NoteSteadyExit(0);
  if (flight_.Enabled()) flight_.Record(FL_STEADY, reason, steady_epoch_);
  timeline_.Instant("steady", "STEADY_EXIT");
}

void Engine::NoteSteadyExit(int r) {
  if (!coord_ || !coord_->steady) return;
  if (r >= 0 && r < static_cast<int>(coord_->steady_exited.size()))
    coord_->steady_exited[r] = true;
}

void Engine::NoteChildSteadyExit(const RequestList& frame, int child_rank) {
  if (!frame.steady_exit || !flight_.Enabled()) return;
  flight_.Record(FL_STEADY,
                 "peer-exit:" + std::to_string(child_rank) + "@" +
                     std::to_string(frame.steady_epoch) + "/" +
                     std::to_string(frame.steady_pos),
                 frame.steady_epoch);
}

double Engine::ParentWaitSec() const {
  if (opts_.collective_timeout_sec <= 0) return 0.0;
  // Star / node-0 worker: the coordinator may block one deadline probing
  // a frozen third rank (2T+5).  Under the tree, rank 0 probes a frozen
  // SUB for 2T+5 before the abort goes out, so a healthy sub waits
  // 3T+10; a leaf sits one relay below its sub and waits 4T+15.
  double T = opts_.collective_timeout_sec;
  if (is_sub_coord_) return 3 * T + 10.0;
  if (tree_enabled_ && opts_.rank >= opts_.local_size) return 4 * T + 15.0;
  return 2 * T + 5.0;
}

bool Engine::AllSteadyExited() const {
  if (!coord_ || !coord_->steady) return true;
  for (size_t r = 0; r < coord_->steady_exited.size(); ++r)
    if (!coord_->steady_exited[r] && !coord_->rank_dead[r]) return false;
  return true;
}

bool Engine::CoordinatorSteadyPoll() {
  // Rank 0 while steady (or holding): frames are exceptional — fallback
  // announcements, steady-exit markers, EOFs.  Drain whatever arrived
  // without blocking; the collective-timeout sweep still covers
  // announced-but-incomplete negotiations (the mid-steady divergence
  // story), and socket EOF still covers crashes.
  // Heartbeat escalation stays live mid-steady: rank 0's own monitor
  // flags drain here (a frozen neighbour is evicted with zero control
  // frames flowing), and workers' out-of-band hb_report frames arrive
  // through the normal drain below — they parse as RequestLists whose
  // dead_ranks CoordinatorHandle consumes.
  CoordinatorDrainHeartbeatDeaths();
  for (int r : coord_children_) {
    if (coord_->rank_dead[r]) continue;
    int fd = coord_fds_[r];
    if (fd < 0) continue;
    bool dead = false;
    while (WaitReadable(fd, 0.0)) {
      std::vector<uint8_t> buf;
      if (!RecvFrame(fd, &buf)) {
        dead = true;
        break;
      }
      ctrl_frames_recv_.fetch_add(1);
      RequestList rl;
      if (ParseRequestList(buf, &rl)) {
        coord_->last_frame_tick[r] = ticks_done_.load();
        coord_->shutdown_requested |= rl.shutdown;
        CoordinatorHandle(rl, r);
      }
    }
    // EOF makes the socket readable, so a dead child always lands in
    // the RecvFrame failure path above — no extra probe per pass.
    if (dead) {
      bool sub_lead = tree_enabled_ && r >= opts_.local_size;
      MarkRankDead(r, sub_lead ? "sub-coordinator connection lost (its "
                                 "node is unreachable)"
                               : "connection lost at the coordinator");
    }
  }
  CheckCollectiveTimeout();
  CheckForStalledTensors();
  if (coord_->abort_code != 0 || coord_->shutdown_requested) {
    // Abort/shutdown broadcasts go out IMMEDIATELY, steady or not: ranks
    // still self-clocking poll their parent socket every pass, and both
    // verdicts drain everything position-independently.  Strip any op
    // payload CoordinatorTick may carry on the shutdown path — ranks at
    // different replay positions must not execute it.
    ResponseList out = CoordinatorTick();
    out.responses.clear();
    out.cache_hits.clear();
    out.shutdown = out.shutdown || coord_->shutdown_requested;
    std::vector<uint8_t> bytes = SerializeResponseList(out);
    for (int r : coord_children_) {
      if (coord_->rank_dead[r] || coord_fds_[r] < 0) continue;
      if (SendFrame(coord_fds_[r], bytes)) ctrl_frames_sent_.fetch_add(1);
    }
    if (steady_active_.load())
      ExitSteadyLocal(out.abort_code != 0 ? "abort" : "shutdown");
    if (out.abort_code != 0) AbortLocal(out.abort_code, out.abort_message);
    return false;
  }
  return true;
}

int Engine::MaybeRevokeSteadyForReshape() {
  if (!opts_.elastic || !coord_ || !coord_->steady) return 0;
  if (coord_->abort_code != 0 || coord_->shutdown_requested) return 0;
  // The normal loop's joiner accept never runs while rank 0 is steady,
  // so drain the listen backlog here — non-blocking — or a standby
  // registering mid-steady would sit unseen until some rank missed.
  CoordinatorAcceptJoiners();
  // Shrink: a death just armed the barrier.  Grow: a standby is waiting
  // and steady state means the control plane is quiesced by construction
  // — no normal tick is coming to host the barrier, so without this the
  // admission would starve until some rank happens to miss.
  if (!coord_->reshape_pending && coord_->pending_join_fds.empty())
    return 0;
  // Broadcast a bare revocation list (no ops, no hits, no reshape):
  // ranks still self-clocking poll their parent socket every pass and
  // treat any payload broadcast as a revocation; ranks that already fell
  // back are blocked on a response and consume it as an empty tick.  The
  // barrier itself then fires on the NEXT regular tick through
  // CoordinatorMaybeReshape, which re-establishes the one-frame-per-
  // child alternation the barrier broadcast relies on (a barrier sent
  // directly from here could cross an in-flight fallback frame; the
  // epoch stamp on RequestList is the backstop for exactly that race).
  ResponseList out;
  out.steady_revoke = true;
  std::vector<uint8_t> bytes = SerializeResponseList(out);
  for (int r : coord_children_) {
    if (coord_->rank_dead[r] || coord_fds_[r] < 0) continue;
    if (SendFrame(coord_fds_[r], bytes)) ctrl_frames_sent_.fetch_add(1);
  }
  coord_->steady = false;
  coord_->steady_revoke_next = false;
  coord_->slot_history.clear();
  if (steady_active_.load()) ExitSteadyLocal("reshape-revoke");
  if (!steady_pending_reqs_.empty()) {
    // Requeue the drained-but-unreplayed partial group: its handles are
    // still in table_, and a dropped announce would strand them forever
    // (hvdmodel's no-deadlock invariant over the bare drop).
    std::lock_guard<std::mutex> lk(mu_);
    for (size_t i = steady_pending_reqs_.size(); i-- > 0;)
      queue_.push_front(std::move(steady_pending_reqs_[i]));
    steady_pending_reqs_.clear();
    steady_pending_group_.clear();
  }
  if (flight_.Enabled())
    flight_.Record(FL_STEADY, "reshape-revoke", steady_epoch_);
  RequestList none;
  return ProcessResponseList(out, none, std::chrono::steady_clock::now())
             ? 1
             : -1;
}

bool Engine::SubRelayPass() {
  // Sub-coordinator while steady (or holding): poll children for
  // fallback frames and forward them upward; poll the parent for
  // broadcasts and relay them down.  Never blocks — children still
  // self-clocking are silent by design.
  RequestList agg;
  SlotIndex idx;
  agg.membership_epoch = membership_epoch_.load();
  // Own monitor flags ride up in this pass's aggregate dead_ranks, same
  // as a child EOF this sub observed.
  {
    std::lock_guard<std::mutex> lk(hb_mu_);
    for (int r : pending_hb_report_) pending_dead_reports_.push_back(r);
    pending_hb_report_.clear();
  }
  for (size_t i = 0; i < tree_child_fds_.size(); ++i) {
    if (tree_child_dead_[i]) continue;
    int fd = tree_child_fds_[i];
    int crank = tree_child_ranks_[i];
    bool dead = false;
    while (WaitReadable(fd, 0.0)) {
      std::vector<uint8_t> buf;
      if (!RecvFrame(fd, &buf)) {
        dead = true;
        break;
      }
      ctrl_frames_recv_.fetch_add(1);
      RequestList child;
      if (ParseRequestList(buf, &child)) {
        NoteChildSteadyExit(child, crank);
        MergeFrameIntoAggregate(child, crank,
                                EpochNowUs() - clock_offset_us_.load(),
                                &agg, &idx);
      }
    }
    if (dead) {
      tree_child_dead_[i] = true;
      pending_dead_reports_.push_back(crank);
    }
  }
  if (!pending_dead_reports_.empty()) {
    for (int32_t r : pending_dead_reports_) agg.dead_ranks.push_back(r);
    pending_dead_reports_.clear();
  }
  if (!agg.requests.empty() || !agg.bit_groups.empty() ||
      !agg.dead_ranks.empty() || !agg.steady_exits.empty() ||
      agg.shutdown) {
    if (!SendFrame(coord_fd_, SerializeRequestList(agg))) {
      ExitSteadyLocal("coordinator-lost");
      AbortLocal(ST_RANKS_DOWN,
                 "ranks down: 0 (coordinator connection lost); this job "
                 "cannot continue and should be restarted.");
      return false;
    }
    ctrl_frames_sent_.fetch_add(1);
  }
  while (coord_fd_ >= 0 && WaitReadable(coord_fd_, 0.0)) {
    std::vector<uint8_t> buf;
    if (!RecvFrame(coord_fd_, &buf)) {
      ExitSteadyLocal("coordinator-lost");
      AbortLocal(ST_RANKS_DOWN,
                 "ranks down: 0 (coordinator connection lost); this job "
                 "cannot continue and should be restarted.");
      return false;
    }
    ctrl_frames_recv_.fetch_add(1);
    // Relay raw bytes down first: whatever this frame is, the children
    // need it too (they are all blocked or polling).
    for (size_t i = 0; i < tree_child_fds_.size(); ++i)
      if (!tree_child_dead_[i] && SendFrame(tree_child_fds_[i], buf))
        ctrl_frames_sent_.fetch_add(1);
    ResponseList rl;
    if (!ParseResponseList(buf, &rl)) continue;
    if (rl.abort_code != 0) {
      ExitSteadyLocal("abort");
      AbortLocal(rl.abort_code, rl.abort_message);
      return false;
    }
    if (rl.shutdown) {
      ExitSteadyLocal("shutdown");
      return false;
    }
    // The resume broadcast (or, defensively, any payload list): leave
    // steady/holding and process it like a normal tick.  Requeue any
    // drained-but-unreplayed partial group first — a mid-steady reshape
    // revocation legitimately lands here with one pending, and the bare
    // drop stranded those handles forever (hvdmodel caught it).
    if (steady_active_.load()) ExitSteadyLocal("broadcast-resumed");
    if (!steady_pending_reqs_.empty()) {
      std::lock_guard<std::mutex> lk(mu_);
      for (size_t i = steady_pending_reqs_.size(); i-- > 0;)
        queue_.push_front(std::move(steady_pending_reqs_[i]));
      steady_pending_reqs_.clear();
      steady_pending_group_.clear();
    }
    sub_holding_ = false;
    RequestList none;
    return ProcessResponseList(rl, none, std::chrono::steady_clock::now());
  }
  return true;
}

bool Engine::SteadyLoopOnce() {
  // 1. Control-socket duty: rank 0 polls its children (fallback frames,
  // EOFs, deadline sweeps); everyone else polls the parent for
  // abort/shutdown frames; sub-coordinators additionally relay.  The
  // duty rides the IDLE cadence: frames are exceptional in steady state
  // (that is the point), so burning O(children) poll syscalls inside
  // every replay burst would put the fan-in term back into the replay
  // path this mode exists to remove — the idle wait (1-10ms) bounds
  // abort/fallback latency instead, with a ~5ms time floor so a
  // pipeline that keeps the queue non-empty on every pass (no idle
  // passes at all) still reads abort/shutdown frames promptly.
  auto duty_now = std::chrono::steady_clock::now();
  if (steady_idle_passes_ > 0 ||
      duty_now - steady_last_poll_ > std::chrono::milliseconds(5)) {
  steady_last_poll_ = duty_now;
  if (opts_.rank == 0) {
    if (!CoordinatorSteadyPoll()) return false;
    int rv = MaybeRevokeSteadyForReshape();
    if (rv < 0) return false;
    if (rv > 0) return true;  // revoked: next pass is a normal tick
  } else {
    // A monitor-latched local abort (grace expired with the coordinator
    // unreachable) surfaces here even with zero frames flowing.
    if (hb_local_abort_.load()) {
      ExitSteadyLocal("heartbeat-abort");
      CheckHeartbeatLocalAbort();
      return false;
    }
    if (is_sub_coord_) {
      if (!SubRelayPass()) return false;
      // SubRelayPass may have exited steady (abort consumed elsewhere);
      // fall through so the normal loop takes over next pass.
      if (!steady_active_.load()) return true;
    } else {
      // Out-of-band heartbeat reports flow mid-steady too — rank 0's
      // steady poll drains them like fallback frames.
      SendHeartbeatReports(coord_fd_);
      while (coord_fd_ >= 0 && WaitReadable(coord_fd_, 0.0)) {
        std::vector<uint8_t> buf;
        if (!RecvFrame(coord_fd_, &buf)) {
          ExitSteadyLocal("coordinator-lost");
          AbortLocal(ST_RANKS_DOWN,
                     "ranks down: 0 (coordinator connection lost); this "
                     "job cannot continue and should be restarted.");
          return false;
        }
        ctrl_frames_recv_.fetch_add(1);
        ResponseList rl;
        if (!ParseResponseList(buf, &rl)) continue;
        if (rl.abort_code != 0) {
          ExitSteadyLocal("abort");
          AbortLocal(rl.abort_code, rl.abort_message);
          return false;
        }
        if (rl.shutdown) {
          ExitSteadyLocal("shutdown");
          return false;
        }
        // Defensively treat any payload broadcast as a revocation.
        // Requeue any drained-but-unreplayed partial group first — a
        // mid-steady reshape revocation legitimately lands here with one
        // pending, and the bare drop stranded those handles forever.
        ExitSteadyLocal("broadcast-resumed");
        if (!steady_pending_reqs_.empty()) {
          std::lock_guard<std::mutex> lk(mu_);
          for (size_t i = steady_pending_reqs_.size(); i-- > 0;)
            queue_.push_front(std::move(steady_pending_reqs_[i]));
          steady_pending_reqs_.clear();
          steady_pending_group_.clear();
        }
        RequestList none;
        return ProcessResponseList(rl, none,
                                   std::chrono::steady_clock::now());
      }
      // (EOF makes the socket readable, so the RecvFrame failure path
      // above already covers a dead parent — no extra probe needed.)
    }
  }
  }
  // 2. A Python-initiated shutdown must reach the coordinator: exit
  // steady so the next (normal) pass sends the shutdown frame.
  if (shut_down_.load()) {
    ExitSteadyLocal("shutdown");
    return true;
  }
  // 3. Drain the queue and replay pattern matches group by group.  A
  // group replays only once COMPLETE (all its slots drained), and a
  // drained request may match ANY not-yet-drained slot of the CURRENT
  // group, not just the next position: a group's slots co-arrived in
  // one negotiation tick, so their per-rank enqueue order carries no
  // cross-rank meaning (async/threaded submitters legitimately differ),
  // and a strict positional match would miss — and fall back — on one
  // rank while its peers replay the fused bucket into the data plane.
  // Replay always executes the group in PATTERN order, so fusion
  // boundaries and execution order stay identical on every rank
  // regardless of local drain order.
  std::deque<Request> drained;
  {
    std::lock_guard<std::mutex> lk(mu_);
    drained.swap(queue_);
  }
  bool replayed = false;
  while (!drained.empty()) {
    Request req = std::move(drained.front());
    drained.pop_front();
    int slot = cache_.Lookup(req);
    // Remaining slots of the current group = pattern[group_base + n]
    // for n in [pending, group_size) where drained slots are tracked in
    // steady_pending_group_ (a multiset of the group's already-drained
    // slots).
    bool match = false;
    if (slot >= 0 && steady_group_idx_ < steady_groups_.size()) {
      size_t group_size = steady_groups_[steady_group_idx_];
      size_t group_base = steady_pos_ - steady_pending_group_.size();
      for (size_t n = 0; n < group_size && !match; ++n) {
        if (steady_pattern_[group_base + n] !=
            static_cast<uint32_t>(slot))
          continue;
        // Slot appears in the group; unmatched iff its multiplicity in
        // the group exceeds its count among already-drained slots.
        size_t in_group = 0, drained_n = 0;
        for (size_t m = 0; m < group_size; ++m)
          if (steady_pattern_[group_base + m] ==
              static_cast<uint32_t>(slot))
            ++in_group;
        for (uint32_t d : steady_pending_group_)
          if (d == static_cast<uint32_t>(slot)) ++drained_n;
        match = drained_n < in_group;
      }
    }
    if (!match) {
      // Miss: fall back to full negotiation for this and everything
      // after it (and everything drained-but-unreplayed before it).
      // Steady state assumes SPMD: under it every rank misses at the
      // same pattern position and the fallback converges (the tests pin
      // this).  A rank whose PROGRAM diverged — it alone misses while
      // peers keep matching — is already a broken job; peers block in
      // the data plane on its missing participation and the failure
      // surfaces through the exchange-silence timeout / EOF cascade as
      // a typed abort, the same quality the star gave mismatched
      // submissions.
      ExitSteadyLocal("miss:" + req.name);
      std::lock_guard<std::mutex> lk(mu_);
      // Requeue in original order AT THE FRONT (entries enqueued after
      // the swap above must stay behind these).
      for (size_t i = drained.size(); i-- > 0;)
        queue_.push_front(std::move(drained[i]));
      queue_.push_front(std::move(req));
      for (size_t i = steady_pending_reqs_.size(); i-- > 0;)
        queue_.push_front(std::move(steady_pending_reqs_[i]));
      steady_pending_reqs_.clear();
      steady_pending_group_.clear();
      return true;
    }
    if (steady_pending_group_.empty())
      steady_group_wait_ = std::chrono::steady_clock::now();
    steady_pending_group_.push_back(static_cast<uint32_t>(slot));
    steady_pending_reqs_.push_back(std::move(req));
    ++steady_pos_;
    cache_hits_.fetch_add(1);
    if (flight_.Enabled())
      flight_.Record(FL_CACHE_HIT, steady_pending_reqs_.back().name, slot);
    if (steady_pending_group_.size() ==
        static_cast<size_t>(steady_groups_[steady_group_idx_])) {
      // Complete replay group: execute exactly like a broadcast list's
      // cache_hits (same fusion walk, same LRU touches — lockstep), in
      // the PATTERN'S canonical slot order — never the local drain
      // order, which may differ per rank within a group.
      std::vector<uint32_t> canonical(
          steady_pattern_.begin() + (steady_pos_ -
                                     steady_pending_group_.size()),
          steady_pattern_.begin() + steady_pos_);
      // Count the group BEFORE executing it: CompleteEntry inside
      // ProcessCacheHits wakes data-plane waiters, and a metrics
      // snapshot taken the instant wait() returns must already include
      // the group (and cycle) that completed it.
      steady_replays_.fetch_add(
          static_cast<int64_t>(steady_pending_group_.size()));
      if (steady_group_idx_ + 1 == steady_groups_.size())
        steady_cycles_.fetch_add(1);
      ProcessCacheHits(canonical);
      steady_pending_group_.clear();
      steady_pending_reqs_.clear();
      ++steady_group_idx_;
      replayed = true;
      if (steady_group_idx_ == steady_groups_.size()) {
        // Pattern wrap = one full self-clocked cycle.  ticks_done_
        // advances HERE (identically on every rank, since the replay
        // stream is identical) so completion stamps and the per-tick
        // lockstep lookups stay cross-rank consistent while the control
        // plane is dark.
        steady_group_idx_ = 0;
        steady_pos_ = 0;
        ++steady_epoch_;
        ticks_done_.fetch_add(1);
        timeline_.Instant("steady", "STEADY_EPOCH");
      }
    }
  }
  // 4. A partial group can starve only if the program's enqueue style
  // changed (the grouping was OBSERVED from real broadcast lists);
  // rather than risk a silent stall, fall back to negotiation.
  if (!steady_pending_group_.empty() &&
      std::chrono::steady_clock::now() - steady_group_wait_ >
          std::chrono::duration<double>(2.0)) {
    ExitSteadyLocal("group-timeout");
    std::lock_guard<std::mutex> lk(mu_);
    for (size_t i = steady_pending_reqs_.size(); i-- > 0;)
      queue_.push_front(std::move(steady_pending_reqs_[i]));
    steady_pending_reqs_.clear();
    steady_pending_group_.clear();
    return true;
  }
  if (!replayed) {
    // Idle: block on the enqueue cv (µs-latency wake when work arrives)
    // with a bounded timeout so the parent-socket poll above still runs
    // for abort/shutdown frames.  The timeout backs off after a few
    // empty passes — enqueues wake the cv directly, so a long timeout
    // costs nothing on the replay path, while hundreds of in-process
    // simulated ranks ticking short timers would entrain the scheduler
    // and show up as milliseconds of wake latency in every cycle.
    int wait_ms = ++steady_idle_passes_ < 4 ? 1 : 10;
    std::unique_lock<std::mutex> lk(mu_);
    if (queue_.empty())
      queue_cv_.wait_for(lk, std::chrono::milliseconds(wait_ms));
  } else {
    steady_idle_passes_ = 0;
  }
  return true;
}

std::string Engine::ControlInfo() {
  return std::string(tree_enabled_ ? "1" : "0") + "|" +
         std::to_string(ctrl_children_.load()) + "|" +
         std::to_string(ctrl_hosts_.load()) + "|" +
         (steady_active_.load() ? "1" : "0") + "|" +
         std::to_string(steady_pattern_len_.load()) + "|" +
         std::to_string(opts_.steady_threshold) + "|" +
         std::to_string(steady_entries_.load()) + "|" +
         std::to_string(steady_exits_.load()) + "|" +
         std::to_string(steady_replays_.load()) + "|" +
         std::to_string(steady_cycles_.load()) + "|" +
         std::to_string(negotiated_ticks_.load()) + "|" +
         std::to_string(ctrl_frames_sent_.load()) + "|" +
         std::to_string(ctrl_frames_recv_.load());
}

// The XLA plane negotiates each collective via a "__xp.<name>" metadata
// allreduce through this engine (jax/eager_mesh.py).  Transport choice is
// dtype-deterministic, so a rank whose dtype is plane-ineligible (f64,
// bool) announces the bare "<name>" while plane ranks announce
// "__xp.<name>" — two pending entries that can never each reach full
// count.  SiblingName maps one to the other so the coordinator can turn
// that split into a typed error (the reference's cross-rank validation
// contract, operations.cc:301-503, extended across transports).
static const char kPlanePrefix[] = "__xp.";

static std::string SiblingName(const std::string& name) {
  const size_t n = sizeof(kPlanePrefix) - 1;
  if (name.compare(0, n, kPlanePrefix) == 0) return name.substr(n);
  return kPlanePrefix + name;
}

static std::string BaseName(const std::string& name) {
  const size_t n = sizeof(kPlanePrefix) - 1;
  if (name.compare(0, n, kPlanePrefix) == 0) return name.substr(n);
  return name;
}

void Engine::CoordinatorHandle(const RequestList& rl, int from_rank) {
  if (rl.membership_epoch < membership_epoch_.load()) {
    // Stale-epoch frame: built against a membership a reshape barrier
    // already replaced (possible only around a mid-steady revocation,
    // which breaks the send-one-wait-one alternation).  Its cache bits
    // name slots the barrier cleared and its announces would pollute the
    // new membership's table, so the whole frame is dropped — the sender
    // re-announces everything after its own ApplyReshape anyway
    // (hvdmodel invariant: no stale-epoch frame is ever accepted).
    if (flight_.Enabled())
      flight_.Record(FL_RESHAPE, "stale-frame:" + std::to_string(from_rank),
                     rl.membership_epoch);
    return;
  }
  int64_t now_us = EpochNowUs();
  bool have_ts = rl.announce_us.size() == rl.requests.size();
  for (size_t i = 0; i < rl.requests.size(); ++i) {
    const Request& req = rl.requests[i];
    // A full string request for a name whose slot (or whose
    // cross-transport sibling's slot) has outstanding cache bits means
    // some rank fell back to full negotiation — a signature change, or a
    // dtype split across transports.  Fold those bits back into their
    // equivalent full requests first, so the validation below sees every
    // rank and the mismatch/typed-error contract still fires.
    CoordinatorDrainBitsFor(req.name);
    CoordinatorDrainBitsFor(SiblingName(req.name));
    // Aggregate frames carry requests from several ranks (each Request
    // names its true rank) plus their announce timestamps on rank 0's
    // clock; direct frames stamp on arrival.
    HandleOneRequest(req, req.rank, have_ts ? rl.announce_us[i] : now_us);
  }
  CoordinatorHandleBits(rl.cache_bits, from_rank);
  for (const auto& g : rl.bit_groups)
    for (size_t j = 0; j < g.ranks.size(); ++j)
      HandleOneBit(g.slot, g.ranks[j],
                   j < g.announce_us.size() && g.announce_us[j] >= 0
                       ? g.announce_us[j]
                       : now_us);
  // Liveness/postmortem accounting for ranks whose frames this aggregate
  // folds in (the per-rank last-frame story must survive aggregation).
  for (int32_t r : rl.frames_from)
    if (r >= 0 && r < static_cast<int>(coord_->last_frame_tick.size()))
      coord_->last_frame_tick[r] = ticks_done_.load();
  // Worker deaths observed elsewhere: control-socket EOF at a
  // sub-coordinator, or — when the frame is an out-of-band heartbeat
  // report — a peer's data-plane beacons going silent.
  for (int32_t r : rl.dead_ranks)
    if (r > 0 && r < opts_.size) {
      if (rl.hb_report && !coord_->rank_dead[r])
        hb_evictions_.fetch_add(1);
      MarkRankDead(r, rl.hb_report
                          ? "missed data-plane heartbeats; process frozen "
                            "or link partitioned"
                          : "connection lost at its sub-coordinator");
    }
  if (rl.steady_exit) {
    // The direct-frame exit marker carries the miss coordinates: land
    // them in rank 0's flight ring so the postmortem can say WHERE in
    // the pattern the fallback happened (sub-coordinators do the same
    // for their leaves as the marker passes through).
    NoteChildSteadyExit(rl, from_rank);
    NoteSteadyExit(from_rank);
  }
  for (int32_t r : rl.steady_exits) NoteSteadyExit(r);
}

Request Engine::SynthesizeFromSlot(const CacheSlot& slot, int rank) const {
  Request r;
  r.rank = rank;
  r.op = slot.op;
  r.dtype = slot.dtype;
  r.root_rank = slot.root_rank;
  r.name = slot.name;
  r.dims = slot.dims;
  // The stored dims are THIS rank's; ragged allgather geometry differs
  // per rank — restore `rank`'s dim0 from the agreed response.
  if (slot.op == OP_ALLGATHER && !r.dims.empty() &&
      rank < static_cast<int>(slot.response.rank_dim0.size()))
    r.dims[0] = slot.response.rank_dim0[rank];
  // A p2p slot stores the pair's agreement, not one rank's request:
  // restore `rank`'s role (the sender re-announces OP_SEND naming the
  // receiver, and vice versa) so renegotiation revalidates the pair.
  if (slot.response.type == RESP_SENDRECV) {
    const Response& a = slot.response;
    r.op = rank == a.p2p_src ? OP_SEND : OP_RECV;
    r.p2p_peer = rank == a.p2p_src ? a.p2p_dst : a.p2p_src;
    r.p2p_tag = a.p2p_tag;
    r.dtype = a.p2p_dtype;
    r.dims = a.p2p_dims;
  }
  r.stage_ranks = slot.response.stage_ranks;
  return r;
}

void Engine::CoordinatorDrainBitsFor(const std::string& name) {
  if (coord_->cache_pending.empty()) return;
  int slot = cache_.SlotByName(name);
  if (slot < 0) return;
  const CacheSlot* s = cache_.Get(slot);
  if (s != nullptr) CoordinatorDrainSlot(slot, *s);
}

void Engine::CoordinatorDrainSlot(int slot, const CacheSlot& contents) {
  auto it = coord_->cache_pending.find(static_cast<uint32_t>(slot));
  if (it == coord_->cache_pending.end()) return;
  Coordinator::PendingBits pb = std::move(it->second);
  coord_->cache_pending.erase(it);
  // Close the NEGOTIATE row the first bit opened; the synthesized
  // requests below re-open it on the full-negotiation path.
  timeline_.NegotiateEnd(contents.name);
  for (int r = 0; r < opts_.size; ++r)
    if (pb.ranks[r]) HandleOneRequest(SynthesizeFromSlot(contents, r), r);
}

void Engine::CoordinatorHandleBits(const std::vector<uint32_t>& bits,
                                   int from_rank) {
  int64_t now_us = EpochNowUs();
  for (uint32_t bit : bits) HandleOneBit(bit, from_rank, now_us);
}

void Engine::HandleOneBit(uint32_t bit, int from_rank, int64_t announce_ts) {
  const CacheSlot* s = cache_.Get(static_cast<int>(bit));
  if (s == nullptr) {
    // Unreachable when every rank runs the same cache state — which
    // Init enforces by agreeing on one job-wide capacity over the
    // coordinator star and the lockstep mutation contract maintains.
    // If it happens anyway, DROPPING the bit would leave the
    // announcing rank waiting forever; abort the job with a crisp
    // status instead.
    if (coord_->abort_code == 0) {
      coord_->abort_code = ST_INVALID;
      coord_->abort_message =
          "response-cache protocol error: rank " +
          std::to_string(from_rank) + " announced cache slot " +
          std::to_string(bit) +
          ", unknown to the coordinator (the ranks disagree on the "
          "negotiation response cache state); this job cannot continue "
          "and should be restarted.";
    }
    return;
  }
  if (coord_->message_table.count(s->name)) {
    // A full (re-)negotiation of this name is in flight: fold the bit
    // in as its equivalent full request so validation sees this rank.
    HandleOneRequest(SynthesizeFromSlot(*s, from_rank), from_rank,
                     announce_ts);
    return;
  }
  auto& pb = coord_->cache_pending[bit];
  if (pb.ranks.empty()) {
    pb.ranks.assign(opts_.size, false);
    pb.first_seen = std::chrono::steady_clock::now();
    timeline_.NegotiateStart(s->name, s->op);
  }
  if (!pb.ranks[from_rank]) {
    pb.ranks[from_rank] = true;
    ++pb.count;
    if (announce_ts < 0) announce_ts = EpochNowUs();
    if (pb.first_us < 0 || announce_ts < pb.first_us)
      pb.first_us = announce_ts;
    if (announce_ts >= pb.last_us) {
      pb.last_us = announce_ts;
      pb.last_rank = from_rank;
    }
    timeline_.NegotiateRankReady(s->name, from_rank, announce_ts);
    if (from_rank <
        static_cast<int>(coord_->last_announce_tick.size())) {
      coord_->last_announce_tick[from_rank] = ticks_done_.load();
      coord_->last_announce_name[from_rank] = s->name;
    }
  }
  // Slot-scoped full count (docs/pipeline.md): a cached p2p pair agrees
  // at TWO bits, a cached stage-group collective at its membership.
  int required = opts_.size;
  if (s->response.type == RESP_SENDRECV)
    required = 2;
  else if (!s->response.stage_ranks.empty())
    required = static_cast<int>(s->response.stage_ranks.size());
  if (pb.count == required) {
    // Agreement by pure bit intersection: no strings were parsed, no
    // Requests rebuilt.  Keep the announce/straggler accounting live in
    // steady state, and mark the NEGOTIATE row as a cache hit.
    if (opts_.size > 1)
      RecordAnnounce(pb.last_rank, pb.last_us - pb.first_us);
    timeline_.Instant(s->name, "NEGOTIATE_CACHED");
    timeline_.NegotiateEnd(s->name);
    // Autotune window accounting: a bit agreement is one negotiated
    // collective of the slot's payload size (the steady-state path the
    // tuner mostly scores).  NOOP slots score zero bytes, matching the
    // fresh-negotiation path — their dims are metadata geometry, not
    // payload, and mixed scoring would bias windows by cache-hit mix.
    if (tuner_.active())
      tuner_.Record(
          s->op == OP_NOOP
              ? 0
              : NumElements(s->dims) *
                    static_cast<int64_t>(DataTypeSize(s->dtype)),
          1);
    coord_->cached_ready.push_back(bit);
    coord_->cache_pending.erase(bit);
  }
}

void Engine::HandleOneRequest(const Request& req, int from_rank,
                              int64_t announce_ts) {
  if (announce_ts < 0) announce_ts = EpochNowUs();
  if (from_rank >= 0 &&
      from_rank < static_cast<int>(coord_->last_announce_tick.size())) {
    coord_->last_announce_tick[from_rank] = ticks_done_.load();
    coord_->last_announce_name[from_rank] = req.name;
  }
  {
    auto& pt = coord_->message_table[req.name];
    if (pt.requests.empty()) {
      pt.first_seen = std::chrono::steady_clock::now();
      pt.order = coord_->next_order++;
      timeline_.NegotiateStart(req.name, req.op);
      std::string base = BaseName(req.name);
      auto poisoned = coord_->poisoned.find(base);
      if (poisoned != coord_->poisoned.end()) {
        auto age = std::chrono::steady_clock::now() - poisoned->second.second;
        if (age > std::chrono::duration<double>(
                      Coordinator::kPoisonWindowSec)) {
          // Expired: the name is usable again, but this announcer may be a
          // very late straggler of the mismatched round whose peers
          // already consumed their error responses — give it a
          // stall-warning-length grace deadline instead of letting it
          // re-pend forever.
          coord_->poisoned.erase(poisoned);
          pt.poison_deadline_tick =
              ticks_done_.load() +
              std::max<int64_t>(
                  Coordinator::kPoisonDeadlineTicks,
                  static_cast<int64_t>(opts_.stall_warning_sec * 1000.0 /
                                       std::max(opts_.cycle_time_ms, 0.1)));
        } else {
          // Defer: full count before the deadline = consistent retry
          // (negotiates normally); stalled at the deadline = straggler of
          // the mismatched round (typed error, swept in CoordinatorTick).
          pt.poison_deadline_tick =
              ticks_done_.load() + Coordinator::kPoisonDeadlineTicks;
        }
      }
      auto sib = coord_->message_table.find(SiblingName(req.name));
      // Only a sibling still PENDING (count < size) indicates a split: a
      // full-count sibling is a validly negotiated collective already in
      // `ready` (erroring it would convert a good op into a spurious
      // failure and double-push its name, double-building the response).
      if (sib != coord_->message_table.end() &&
          !sib->second.requests.empty() &&
          static_cast<int>(sib->second.requests.size()) < opts_.size &&
          sib->second.forced_error.empty() && pt.forced_error.empty()) {
        std::string msg =
            "cross-transport mismatch for tensor '" + base +
            "': some ranks submitted it over the XLA data plane while "
            "others fell back to the TCP engine (rank " +
            std::to_string(req.rank) + " vs rank " +
            std::to_string(sib->second.requests[0].rank) +
            ").  The transport is chosen by dtype, so this means the "
            "ranks disagree on the tensor's dtype (e.g. float32 on one "
            "rank, float64/bool on another); every rank must submit the "
            "same collective with the same dtype.";
        pt.forced_error = msg;
        sib->second.forced_error = msg;
        if (coord_->poisoned.size() > 1024) coord_->poisoned.clear();
        coord_->poisoned[base] = {msg, std::chrono::steady_clock::now()};
        coord_->ready.push_back(req.name);
        coord_->ready.push_back(sib->first);
      }
    }
    timeline_.NegotiateRankReady(req.name, from_rank, announce_ts);
    if (pt.first_us < 0 || announce_ts < pt.first_us)
      pt.first_us = announce_ts;
    if (announce_ts >= pt.last_us) {
      pt.last_us = announce_ts;
      pt.last_rank = from_rank;
    }
    pt.requests.push_back(req);
    // forced_error entries were already pushed to ready at detection; a
    // second push here would double-build (and double-erase) the entry.
    // The full count is op-scoped (docs/pipeline.md): a send/recv pair
    // completes at TWO announcements (paired readiness — sender and
    // receiver must both have posted), a stage-scoped collective at its
    // group's membership, everything else at the whole world.
    if (static_cast<int>(pt.requests.size()) ==
            RequiredCount(pt.requests[0], opts_.size) &&
        pt.forced_error.empty()) {
      if (pt.poison_deadline_tick != 0) {
        // Every rank re-announced consistently: the mismatch is resolved;
        // the name negotiates normally and the poison clears.
        coord_->poisoned.erase(BaseName(req.name));
        pt.poison_deadline_tick = 0;
      }
      // Straggler attribution: the rank with the LATEST announce
      // timestamp announced last; skew = first -> last announce.  Tree
      // aggregates forward the true per-rank times, so this names the
      // real straggler rank, not the sub-coordinator.  At size 1 every
      // count completes instantly — pure noise, skip.
      if (opts_.size > 1)
        RecordAnnounce(pt.last_rank, pt.last_us - pt.first_us);
      timeline_.NegotiateEnd(req.name);
      coord_->ready.push_back(req.name);
    }
  }
}

Response Engine::BuildResponse(const std::string& name) {
  // Cross-rank consistency validation, mirroring the checks in the
  // reference's ConstructMPIResponse (operations.cc:301-503): op, dtype,
  // shape (exact for allreduce/broadcast, all-but-dim-0 for allgather) and
  // broadcast root must agree across ranks.
  auto it = coord_->message_table.find(name);
  Response resp;
  resp.names.push_back(name);
  if (!it->second.forced_error.empty()) {
    resp.type = RESP_ERROR;
    resp.error_message = it->second.forced_error;
    // Close the NEGOTIATE row opened at first announce (the normal path
    // closes it at full count, which forced errors never reach).
    timeline_.NegotiateEnd(name);
    coord_->message_table.erase(it);
    return resp;
  }
  auto& reqs = it->second.requests;
  const Request& first = reqs[0];
  std::string error;
  if (first.op == OP_SEND || first.op == OP_RECV) {
    // Point-to-point pair (docs/pipeline.md): exactly two announcements
    // reached the full count — one OP_SEND and one OP_RECV, each naming
    // the other rank as its peer, with equal tag, dtype and shape.  The
    // agreement broadcasts to EVERY rank (caches mutate in lockstep);
    // only the pair executes it.
    const Request& a = reqs[0];
    const Request& b = reqs[1];
    const Request& snd = a.op == OP_SEND ? a : b;
    const Request& rcv = a.op == OP_SEND ? b : a;
    if (a.op == b.op)
      error = std::string("Mismatched point-to-point operations for '") +
              BaseName(name) + "': ranks " + std::to_string(a.rank) +
              " and " + std::to_string(b.rank) + " both posted " +
              OpName(a.op) +
              "; a pair needs one send and one matching recv.";
    else if (snd.p2p_peer != rcv.rank || rcv.p2p_peer != snd.rank)
      error = "Mismatched point-to-point peers for '" + BaseName(name) +
              "': rank " + std::to_string(snd.rank) +
              " sends to rank " + std::to_string(snd.p2p_peer) +
              " but rank " + std::to_string(rcv.rank) +
              " receives from rank " + std::to_string(rcv.p2p_peer) + ".";
    else if (snd.p2p_tag != rcv.p2p_tag)
      error = "Mismatched point-to-point tags for '" + BaseName(name) +
              "': send tag " + std::to_string(snd.p2p_tag) +
              " vs recv tag " + std::to_string(rcv.p2p_tag) + ".";
    else if (snd.dtype != rcv.dtype)
      error = std::string("Mismatched point-to-point data types: the "
                          "sender ships ") +
              DataTypeName(snd.dtype) + ", the receiver expects " +
              DataTypeName(rcv.dtype) + ".";
    else if (snd.dims != rcv.dims)
      error = "Mismatched point-to-point tensor shapes: the sender "
              "ships " + DimsToString(snd.dims) +
              ", the receiver expects " + DimsToString(rcv.dims) + ".";
    if (!error.empty()) {
      resp.type = RESP_ERROR;
      resp.error_message = error;
    } else {
      resp.type = RESP_SENDRECV;
      resp.p2p_src = snd.rank;
      resp.p2p_dst = rcv.rank;
      resp.p2p_tag = snd.p2p_tag;
      resp.p2p_dtype = snd.dtype;
      resp.p2p_dims = snd.dims;
    }
    // The NEGOTIATE row closed in HandleOneRequest at full count (2).
    coord_->message_table.erase(it);
    return resp;
  }
  for (size_t i = 1; i < reqs.size() && error.empty(); ++i) {
    const Request& r = reqs[i];
    if (r.op != first.op) {
      if (r.op == OP_NOOP || first.op == OP_NOOP) {
        // One camp replayed the cached cross-rank agreement (the XLA
        // plane's metadata-cache fast path) while another re-submitted
        // changed metadata: the shape/dtype/root consistency the metadata
        // allreduce would have checked no longer holds across ranks.
        int noop_rank = r.op == OP_NOOP ? r.rank : first.rank;
        int full_rank = r.op == OP_NOOP ? first.rank : r.rank;
        error = "Mismatched collective metadata for tensor '" +
                BaseName(name) + "': rank " + std::to_string(noop_rank) +
                " replayed the cached cross-rank agreement while rank " +
                std::to_string(full_rank) +
                " submitted changed metadata (shape/dtype/root); every "
                "rank must submit the same collective with the same shape "
                "and dtype.";
      } else {
        error = "Mismatched collective operations: rank " +
                std::to_string(r.rank) + " requested " + OpName(r.op) +
                ", rank " + std::to_string(first.rank) + " requested " +
                OpName(first.op) + ".";
      }
    } else if (r.dtype != first.dtype)
      error = std::string("Mismatched data types: one rank sent ") +
              DataTypeName(r.dtype) + ", another sent " +
              DataTypeName(first.dtype) + ".";
    else if (r.stage_ranks != first.stage_ranks)
      error = "Mismatched stage groups for '" + BaseName(name) +
              "': ranks " + std::to_string(r.rank) + " and " +
              std::to_string(first.rank) +
              " scoped the collective to different member lists; every "
              "member must pass the same stage group.";
    else if ((first.op == OP_ALLREDUCE || first.op == OP_NOOP) &&
             r.dims != first.dims)
      error = "Mismatched allreduce tensor shapes: one rank sent " +
              DimsToString(r.dims) + ", another sent " +
              DimsToString(first.dims) + ".";
    else if (first.op == OP_BROADCAST &&
             (r.dims != first.dims || r.root_rank != first.root_rank))
      error = r.root_rank != first.root_rank
                  ? "Mismatched broadcast root ranks: one rank requested root " +
                        std::to_string(r.root_rank) +
                        ", another requested root " +
                        std::to_string(first.root_rank) + "."
                  : "Mismatched broadcast tensor shapes: one rank sent " +
                        DimsToString(r.dims) + ", another sent " +
                        DimsToString(first.dims) + ".";
    else if (first.op == OP_ALLGATHER) {
      if (r.dims.size() != first.dims.size() || r.dims.empty())
        error = "Mismatched allgather tensor ranks (all ranks must send "
                "tensors of the same rank, with rank >= 1).";
      else
        for (size_t d = 1; d < r.dims.size(); ++d)
          if (r.dims[d] != first.dims[d]) {
            error = "Mismatched allgather tensor shapes: dimensions beyond "
                    "the first must agree across ranks (" +
                    DimsToString(r.dims) + " vs " + DimsToString(first.dims) +
                    ").";
            break;
          }
    }
  }
  if (first.op == OP_ALLGATHER && first.dims.empty())
    error = "Allgather requires tensors of rank >= 1.";
  if (first.op == OP_BROADCAST &&
      (first.root_rank < 0 || first.root_rank >= opts_.size))
    error = "Broadcast root rank " + std::to_string(first.root_rank) +
            " out of range [0, " + std::to_string(opts_.size) + ").";
  if (error.empty() && !first.stage_ranks.empty() &&
      first.op != OP_ALLREDUCE)
    error = std::string("Stage groups scope only allreduce; '") +
            BaseName(name) + "' requested " + OpName(first.op) + ".";
  if (!error.empty()) {
    resp.type = RESP_ERROR;
    resp.error_message = error;
  } else if (first.op == OP_ALLREDUCE) {
    resp.type = RESP_ALLREDUCE;
    if (!first.stage_ranks.empty()) {
      // Stage-scoped (docs/pipeline.md): the broadcast carries the
      // membership plus the payload signature, so NON-members can mutate
      // their response caches in lockstep without ever having seen a
      // request for this name.
      resp.stage_ranks = first.stage_ranks;
      resp.p2p_dtype = first.dtype;
      resp.p2p_dims = first.dims;
    }
  } else if (first.op == OP_NOOP) {
    resp.type = RESP_NOOP;
  } else if (first.op == OP_BROADCAST) {
    resp.type = RESP_BROADCAST;
  } else {
    resp.type = RESP_ALLGATHER;
    resp.rank_dim0.assign(opts_.size, 0);
    for (const Request& r : reqs) resp.rank_dim0[r.rank] = r.dims[0];
  }
  coord_->message_table.erase(it);
  return resp;
}

ResponseList Engine::CoordinatorTick() {
  ResponseList out;
  out.shutdown = coord_->shutdown_requested;
  if (coord_->abort_code != 0) {
    // Coordinated abort: carry only the abort verdict.  Deliberately no
    // op responses — a "ready" op would execute over ring sockets the
    // dead rank just broke; draining everything with the abort status is
    // uniform and safe.
    out.abort_code = coord_->abort_code;
    out.abort_message = coord_->abort_message;
    out.shutdown = true;
    return out;
  }
  // Cache hits agreed this tick: broadcast the slot indices; every rank
  // replays its stored response for each, in this order.
  out.cache_hits.swap(coord_->cached_ready);
  // Poison-deadline sweep: entries for a recently-mismatched base name
  // that are STILL short of full count at their deadline are stragglers
  // of the mismatched round — give them the typed error.
  const int64_t now_tick = ticks_done_.load();
  for (auto& kv : coord_->message_table) {
    auto& pt = kv.second;
    if (pt.poison_deadline_tick != 0 && now_tick >= pt.poison_deadline_tick &&
        pt.forced_error.empty() && !pt.requests.empty()) {
      auto poisoned = coord_->poisoned.find(BaseName(kv.first));
      pt.forced_error =
          poisoned != coord_->poisoned.end()
              ? poisoned->second.first
              : "cross-transport mismatch for tensor '" + BaseName(kv.first) +
                    "' (straggler of an earlier mismatched round).";
      coord_->ready.push_back(kv.first);
    }
  }
  if (coord_->ready.empty()) return out;
  std::vector<std::string> ready;
  ready.swap(coord_->ready);
  std::vector<Response> responses;
  std::vector<int64_t> nbytes;   // per response, for fusion accounting
  std::vector<uint8_t> ndtypes;  // per response, for the compression verdict
  for (const auto& name : ready) {
    // Byte size must be computed before BuildResponse erases the table entry.
    auto& pt = coord_->message_table[name];
    const Request& first = pt.requests[0];
    int64_t bytes = NumElements(first.dims) *
                    static_cast<int64_t>(DataTypeSize(first.dtype));
    uint8_t dtype = first.dtype;
    Response r = BuildResponse(name);
    // Autotune window accounting: one fresh negotiation of `bytes`
    // payload (negotiation-only no-ops score as ops moving zero bytes).
    if (tuner_.active() && r.type != RESP_ERROR)
      tuner_.Record(r.type == RESP_NOOP ? 0 : bytes, 1);
    // Tensor fusion: merge consecutive same-dtype allreduces while the fused
    // payload stays under the threshold (operations.cc:1607-1642).
    if (r.type == RESP_ALLREDUCE && r.stage_ranks.empty() &&
        !responses.empty() &&
        FusesInto(responses.back(), nbytes.back(), last_fused_dtype_, dtype,
                  bytes, opts_.fusion_threshold)) {
      responses.back().names.push_back(name);
      nbytes.back() += bytes;
    } else {
      responses.push_back(std::move(r));
      nbytes.push_back(bytes);
      ndtypes.push_back(dtype);
      last_fused_dtype_ = dtype;
    }
  }
  // Wire-compression verdict, per FINAL bucket (the fusion loop above may
  // have grown a bucket past the min-bytes floor, so the decision runs
  // after fusion settles): stamped on the broadcast response so every
  // rank packs/unpacks the same format.  The COMPRESS attr also lands on
  // each tensor's NEGOTIATE timeline row at the coordinator.
  for (size_t i = 0; i < responses.size(); ++i) {
    Response& r = responses[i];
    if (r.type == RESP_SENDRECV) {
      // A p2p transfer compresses only when the pair spans nodes (the
      // DCN hop, where bytes cost money) and the payload is fp32 — the
      // same policy the two-level allreduce applies to its cross hop.
      // The verdict is stored with the cached agreement and replayed
      // verbatim: p2p never re-fuses, so there is no bucket geometry to
      // recompute at replay time.
      bool cross_node =
          opts_.hierarchical_allreduce && opts_.local_size > 0 &&
          r.p2p_src / opts_.local_size != r.p2p_dst / opts_.local_size;
      if (cross_node && r.p2p_dtype == HVD_FLOAT32)
        r.compression = ChooseCompression(r.p2p_dtype, nbytes[i]);
      continue;
    }
    if (r.type != RESP_ALLREDUCE || !r.stage_ranks.empty()) continue;
    r.compression = ChooseCompression(ndtypes[i], nbytes[i]);
    if (r.compression != COMP_NONE && timeline_.Enabled())
      for (const auto& name : r.names)
        timeline_.Instant(
            name, std::string("COMPRESS_") + CompressionName(r.compression));
  }
  out.responses = std::move(responses);
  return out;
}

void Engine::CheckForStalledTensors() {
  auto now = std::chrono::steady_clock::now();
  if (now - last_stall_check_ <
      std::chrono::duration<double>(opts_.stall_warning_sec))
    return;
  last_stall_check_ = now;
  bool preamble = false;
  // One record per stalled negotiation, whether it is pending as full
  // string requests (message_table) or as cache-bit announcements.
  auto warn = [&](const std::string& name, const std::vector<bool>& present,
                  std::chrono::steady_clock::time_point first_seen) {
    {
      // Record for the Python metrics registry (hvd_tpu_stall_count /
      // hvd_tpu_stall_info): one event per (tensor, sweep) warning.
      double stalled_sec =
          std::chrono::duration<double>(now - first_seen).count();
      std::lock_guard<std::mutex> lk(stall_mu_);
      ++stall_events_;
      stall_log_.emplace_back(name, stalled_sec);
      while (stall_log_.size() > 64) stall_log_.pop_front();
    }
    if (flight_.Enabled())
      flight_.Record(
          FL_STALL, name,
          static_cast<int64_t>(
              std::chrono::duration<double>(now - first_seen).count()));
    if (!preamble) {
      fprintf(stderr,
              "[horovod_tpu] WARNING: One or more tensors were submitted to "
              "be reduced, gathered or broadcasted by subset of ranks and are "
              "waiting for remainder of ranks for more than %.0f seconds. "
              "This may indicate that different ranks are trying to submit "
              "different tensors or that only subset of ranks is submitting "
              "tensors, which will cause deadlock.\nStalled ops:\n",
              opts_.stall_warning_sec);
      preamble = true;
    }
    fprintf(stderr, "%s [missing ranks: %s]\n", name.c_str(),
            MissingRanks(present).c_str());
  };
  for (const auto& kv : coord_->message_table) {
    if (now - kv.second.first_seen <
        std::chrono::duration<double>(opts_.stall_warning_sec))
      continue;
    // Ranks outside a partial-participation op's expected set are not
    // "missing" — mask them present so the warning names only the
    // genuinely absent participants (the p2p peer, the stage members).
    std::vector<bool> present(opts_.size, false);
    for (const auto& r : kv.second.requests)
      if (r.rank >= 0 && r.rank < opts_.size) present[r.rank] = true;
    std::vector<bool> expected =
        ExpectedRanks(kv.second.requests, opts_.size);
    for (int r = 0; r < opts_.size; ++r)
      if (!expected[r]) present[r] = true;
    warn(kv.first, present, kv.second.first_seen);
  }
  for (const auto& kv : coord_->cache_pending) {
    if (now - kv.second.first_seen <
        std::chrono::duration<double>(opts_.stall_warning_sec))
      continue;
    const CacheSlot* s = cache_.Get(static_cast<int>(kv.first));
    std::vector<bool> present = kv.second.ranks;
    std::vector<bool> expected = SlotExpectedRanks(s, opts_.size);
    for (int r = 0; r < opts_.size && r < static_cast<int>(present.size());
         ++r)
      if (!expected[r]) present[r] = true;
    warn(s ? s->name : "<cache slot " + std::to_string(kv.first) + ">",
         present, kv.second.first_seen);
  }
}

int64_t Engine::StallEvents() {
  std::lock_guard<std::mutex> lk(stall_mu_);
  return stall_events_;
}

std::string Engine::StallInfo() {
  std::lock_guard<std::mutex> lk(stall_mu_);
  std::string out;
  for (const auto& rec : stall_log_) {
    if (!out.empty()) out += ';';
    for (char c : rec.first) out += (c == ';' || c == '|') ? '_' : c;
    char buf[32];
    snprintf(buf, sizeof(buf), "|%.3f", rec.second);
    out += buf;
  }
  return out;
}

// ---------------------------------------------------------------------------
// Coordinated abort (fault tolerance, docs/fault-tolerance.md).
// ---------------------------------------------------------------------------

namespace {

// "a, b [missing ranks: 1, 3]" for one pending tensor.  An unmatched
// p2p announce names the tensor AND the absent counterpart explicitly —
// the paired-readiness diagnosis docs/pipeline.md#fault-semantics
// promises ("rank 1's send of 'act_s0' waits on rank 2's recv").
std::string DescribePending(const std::string& name,
                            const std::vector<Request>& reqs, int size) {
  if (reqs.size() == 1 &&
      (reqs[0].op == OP_SEND || reqs[0].op == OP_RECV)) {
    const Request& r = reqs[0];
    return "'" + name + "' [" + OpName(r.op) + " announced by rank " +
           std::to_string(r.rank) + "; waiting for the matching " +
           (r.op == OP_SEND ? "recv" : "send") + " from peer rank " +
           std::to_string(r.p2p_peer) + "]";
  }
  std::vector<bool> present(size, false);
  for (const auto& r : reqs)
    if (r.rank >= 0 && r.rank < size) present[r.rank] = true;
  std::vector<bool> expected = ExpectedRanks(reqs, size);
  std::string missing;
  for (int r = 0; r < size; ++r)
    if (expected[r] && !present[r])
      missing += (missing.empty() ? "" : ", ") + std::to_string(r);
  return "'" + name + "' [missing ranks: " + missing + "]";
}

}  // namespace

void Engine::MarkRankDead(int r, const std::string& reason) {
  if (coord_->rank_dead[r]) return;
  coord_->rank_dead[r] = true;
  if (opts_.elastic && coord_->abort_code == 0) {
    // Shrink-and-continue (docs/fault-tolerance.md#elastic-membership):
    // with enough survivors, arm a reshape barrier at the next tick
    // instead of the fatal abort cascade.  Rank 0 hosts the coordinator,
    // so it is alive by construction here; more deaths observed in the
    // same sweep accumulate into the same barrier, and dropping below
    // min_size falls through to the abort (the checkpoint-restart
    // fallback hvdrun --min-np relies on).
    int alive = 0;
    for (int i = 0; i < opts_.size; ++i)
      if (!coord_->rank_dead[i]) ++alive;
    if (alive >= std::max<int64_t>(opts_.min_size, 1)) {
      coord_->reshape_pending = true;
      fprintf(stderr,
              "[horovod_tpu] WARNING: rank %d down (%s); elastic reshape "
              "at the next tick (%d survivor(s), membership epoch %lld -> "
              "%lld).\n",
              r, reason.c_str(), alive,
              static_cast<long long>(membership_epoch_.load()),
              static_cast<long long>(membership_epoch_.load() + 1));
      return;
    }
    coord_->reshape_pending = false;  // below min_size: abort instead
  }
  if (coord_->abort_code != 0) return;  // first abort wins
  std::string down;
  std::vector<int> dead_ranks;
  for (int i = 0; i < opts_.size; ++i)
    if (coord_->rank_dead[i]) {
      down += (down.empty() ? "" : ", ") + std::to_string(i);
      dead_ranks.push_back(i);
    }
  std::string pending;
  int listed = 0;
  for (const auto& kv : coord_->message_table) {
    if (listed == 8) {
      pending += ", ...";
      break;
    }
    pending += (pending.empty() ? "" : "; ") +
               DescribePending(kv.first, kv.second.requests, opts_.size);
    ++listed;
  }
  for (const auto& kv : coord_->cache_pending) {
    if (listed == 8) {
      pending += ", ...";
      break;
    }
    const CacheSlot* s = cache_.Get(static_cast<int>(kv.first));
    pending += (pending.empty() ? "" : "; ") + std::string("'") +
               (s ? s->name : "<cache slot>") +
               "' [missing ranks: " + MissingRanks(kv.second.ranks) + "]";
    ++listed;
  }
  coord_->abort_code = ST_RANKS_DOWN;
  coord_->abort_message =
      "ranks down: " + down + " (" + reason + ")" +
      (pending.empty() ? std::string(".")
                       : "; pending collective(s): " + pending + ".") +
      (opts_.elastic
           ? " Survivors fell below the elastic minimum (--min-np " +
                 std::to_string(static_cast<long long>(opts_.min_size)) +
                 "), so the job cannot shrink further."
           : std::string()) +
      " The job was aborted; restart it (e.g. hvdrun --max-restarts) to "
      "resume from the latest checkpoint." +
      " cross-rank diagnosis: " + BuildDiagnosis(dead_ranks);
}

void Engine::CheckCollectiveTimeout() {
  if (opts_.collective_timeout_sec <= 0 || coord_->abort_code != 0) return;
  // An armed reshape barrier poisons every in-flight collective with the
  // retryable ST_RESHAPE at this very tick and clears the pending
  // tables.  Entries here may already be past the timeout — the liveness
  // WaitReadable that detected the dead rank blocked for the full
  // timeout while they aged — so latching fatal ST_TIMEOUT now would
  // preempt the shrink-and-continue the elastic path just armed (a
  // frozen rank would kill the job where a crashed one would not).
  if (coord_->reshape_pending) return;
  auto now = std::chrono::steady_clock::now();
  std::string stalled;
  double worst = 0.0;
  int n_stalled = 0;
  std::vector<bool> missing_any(opts_.size, false);
  auto note_missing = [&](const std::vector<bool>& present) {
    for (int r = 0; r < opts_.size && r < static_cast<int>(present.size());
         ++r)
      if (!present[r]) missing_any[r] = true;
  };
  for (const auto& kv : coord_->message_table) {
    if (kv.second.requests.empty() || !kv.second.forced_error.empty())
      continue;
    double age =
        std::chrono::duration<double>(now - kv.second.first_seen).count();
    if (age < opts_.collective_timeout_sec) continue;
    worst = std::max(worst, age);
    ++n_stalled;
    // Mask ranks outside the op's expected participant set (p2p pair /
    // stage group): the abort must name the absent counterpart, not the
    // whole uninvolved world.
    std::vector<bool> present(opts_.size, false);
    for (const auto& r : kv.second.requests)
      if (r.rank >= 0 && r.rank < opts_.size) present[r.rank] = true;
    std::vector<bool> expected =
        ExpectedRanks(kv.second.requests, opts_.size);
    for (int r = 0; r < opts_.size; ++r)
      if (!expected[r]) present[r] = true;
    note_missing(present);
    if (n_stalled <= 8)
      stalled += (stalled.empty() ? "" : "; ") +
                 DescribePending(kv.first, kv.second.requests, opts_.size);
  }
  for (const auto& kv : coord_->cache_pending) {
    double age =
        std::chrono::duration<double>(now - kv.second.first_seen).count();
    if (age < opts_.collective_timeout_sec) continue;
    worst = std::max(worst, age);
    ++n_stalled;
    const CacheSlot* s = cache_.Get(static_cast<int>(kv.first));
    std::vector<bool> present = kv.second.ranks;
    std::vector<bool> expected = SlotExpectedRanks(s, opts_.size);
    for (int r = 0; r < opts_.size && r < static_cast<int>(present.size());
         ++r)
      if (!expected[r]) present[r] = true;
    note_missing(present);
    if (n_stalled <= 8) {
      stalled += (stalled.empty() ? "" : "; ") + std::string("'") +
                 (s ? s->name : "<cache slot>") +
                 "' [missing ranks: " + MissingRanks(present) + "]";
    }
  }
  if (n_stalled == 0) return;
  std::vector<int> missing_ranks;
  for (int r = 0; r < opts_.size; ++r)
    if (missing_any[r]) missing_ranks.push_back(r);
  if (n_stalled > 8)
    stalled += "; ... (" + std::to_string(n_stalled - 8) + " more)";
  char worst_buf[32];
  snprintf(worst_buf, sizeof(worst_buf), "%.1f", worst);
  coord_->abort_code = ST_TIMEOUT;
  coord_->abort_message =
      std::string("collective timeout: tensor(s) stalled for ") + worst_buf +
      "s (> HVD_TPU_COLLECTIVE_TIMEOUT_SEC=" +
      std::to_string(static_cast<long long>(opts_.collective_timeout_sec)) +
      "): " + stalled +
      ". One or more ranks never submitted the matching collective; the "
      "job was aborted instead of hanging." +
      " cross-rank diagnosis: " + BuildDiagnosis(missing_ranks);
}

void Engine::AbortLocal(int32_t code, const std::string& message) {
  // Freeze the in-flight table BEFORE the latch: the BackgroundLoop
  // drain clears table_ moments later, and the postmortem dump must
  // still know what was pending at the moment of death.
  std::string pending = LivePendingInfo();
  {
    std::lock_guard<std::mutex> lk(abort_mu_);
    if (abort_code_.load() != 0) return;  // first abort wins
    abort_message_ = message;
    abort_pending_info_ = std::move(pending);
    abort_code_.store(code);
  }
  abort_events_.fetch_add(1);
  if (flight_.Enabled()) flight_.Record(FL_ABORT, "", code);
  // A broken job must fail every subsequent collective uniformly.
  data_plane_failed_.store(true);
  // Invalidate the response cache: the peers' caches die with the job,
  // and a relaunch must renegotiate from scratch (docs/performance.md).
  cache_.Clear();
  cache_size_.store(0);
  if (coord_) coord_->cache_pending.clear();
  // Aborting jobs often die before Python reaches shutdown(): flush now
  // so the trace on disk parses (the BackgroundLoop drain flushes again
  // after the final completions land).
  timeline_.Flush();
  fprintf(stderr, "[horovod_tpu] ERROR: coordinated abort on rank %d: %s\n",
          opts_.rank, message.c_str());
}

std::string Engine::AbortMessage() {
  std::lock_guard<std::mutex> lk(abort_mu_);
  return abort_message_;
}

// ---------------------------------------------------------------------------
// Postmortem plane (flight recorder drains, pending tables, diagnosis).
// ---------------------------------------------------------------------------

namespace {

// The marker Python and Diagnosis() split the broadcast abort message on.
const char kDiagnosisMarker[] = "cross-rank diagnosis: ";

std::string SanitizeInfo(const std::string& s) {
  std::string out;
  out.reserve(s.size());
  for (char c : s) out += (c == ';' || c == '|') ? '_' : c;
  return out;
}

}  // namespace

std::string Engine::BuildDiagnosis(const std::vector<int>& missing) {
  // Engine thread only (coordinator tables).  One paragraph: where the
  // job is, and — for each rank a stalled collective waits on — the last
  // thing the coordinator ever heard from it.  This is the "rank 2
  // stopped announcing after tick 1841" story the postmortem renders.
  if (!coord_) return "no coordinator state on this rank.";
  int64_t cur = ticks_done_.load();
  std::string out = "the coordinator is at tick " + std::to_string(cur);
  if (missing.empty()) return out + "; no rank is missing.";
  for (int r : missing) {
    out += "; rank " + std::to_string(r);
    bool announced =
        r >= 0 && r < static_cast<int>(coord_->last_announce_tick.size()) &&
        coord_->last_announce_tick[r] >= 0;
    if (announced) {
      out += " last announced '" + coord_->last_announce_name[r] +
             "' at tick " + std::to_string(coord_->last_announce_tick[r]) +
             " and stopped announcing after that";
    } else {
      out += " never announced any collective";
    }
    if (r > 0 && r < static_cast<int>(coord_->last_frame_tick.size())) {
      out += coord_->last_frame_tick[r] >= 0
                 ? " (last control-plane frame at tick " +
                       std::to_string(coord_->last_frame_tick[r]) + ")"
                 : " (no control-plane frame ever received)";
    }
  }
  return out + ".";
}

std::string Engine::Diagnosis() {
  std::lock_guard<std::mutex> lk(abort_mu_);
  size_t pos = abort_message_.find(kDiagnosisMarker);
  if (pos == std::string::npos) return "";
  return abort_message_.substr(pos + sizeof(kDiagnosisMarker) - 1);
}

std::string Engine::LivePendingInfo() {
  auto now = std::chrono::steady_clock::now();
  std::string out;
  std::lock_guard<std::mutex> lk(mu_);
  int listed = 0;
  for (const auto& kv : table_) {
    if (listed++ == 64) break;
    int64_t age_us = std::chrono::duration_cast<std::chrono::microseconds>(
                         now - kv.second.enqueued_at)
                         .count();
    out += (out.empty() ? "" : ";") + SanitizeInfo(kv.first) + "|" +
           OpName(kv.second.op) + "|" + std::to_string(age_us);
  }
  return out;
}

std::string Engine::PendingInfo() {
  std::string live = LivePendingInfo();
  if (!live.empty()) return live;
  // Post-abort the drain has emptied the table; serve the snapshot the
  // abort froze instead.
  std::lock_guard<std::mutex> lk(abort_mu_);
  return abort_code_.load() != 0 ? abort_pending_info_ : live;
}

void Engine::UpdateCoordPendingInfo() {
  // Engine thread, rank 0 (and size-1), once per tick.  Negotiations
  // normally resolve within a tick or two, so the tables are almost
  // always empty and this is a lock + an empty-compare.
  if (!coord_) return;
  std::string info;
  auto now = std::chrono::steady_clock::now();
  int listed = 0;
  for (const auto& kv : coord_->message_table) {
    if (listed++ == 64) break;
    if (kv.second.requests.empty()) continue;
    std::vector<bool> present(opts_.size, false);
    for (const auto& r : kv.second.requests)
      if (r.rank >= 0 && r.rank < opts_.size) present[r.rank] = true;
    int64_t age_us = std::chrono::duration_cast<std::chrono::microseconds>(
                         now - kv.second.first_seen)
                         .count();
    std::string missing;
    for (int r = 0; r < opts_.size; ++r)
      if (!present[r])
        missing += (missing.empty() ? "" : " ") + std::to_string(r);
    info += (info.empty() ? "" : ";") + SanitizeInfo(kv.first) + "|" +
            std::to_string(age_us) + "|" + missing;
  }
  for (const auto& kv : coord_->cache_pending) {
    if (listed++ == 64) break;
    const CacheSlot* s = cache_.Get(static_cast<int>(kv.first));
    int64_t age_us = std::chrono::duration_cast<std::chrono::microseconds>(
                         now - kv.second.first_seen)
                         .count();
    std::string missing;
    for (int r = 0;
         r < opts_.size && r < static_cast<int>(kv.second.ranks.size()); ++r)
      if (!kv.second.ranks[r])
        missing += (missing.empty() ? "" : " ") + std::to_string(r);
    info += (info.empty() ? "" : ";") +
            SanitizeInfo(s ? s->name
                           : "<cache slot " + std::to_string(kv.first) + ">") +
            "|" + std::to_string(age_us) + "|" + missing;
  }
  std::lock_guard<std::mutex> lk(coord_info_mu_);
  if (coord_pending_info_ != info) coord_pending_info_ = std::move(info);
}

std::string Engine::CoordPendingInfo() {
  std::lock_guard<std::mutex> lk(coord_info_mu_);
  return coord_pending_info_;
}

// ---------------------------------------------------------------------------
// Online autotuning (docs/performance.md#autotuning).
// ---------------------------------------------------------------------------

void Engine::AttachTunedParams(ResponseList* out) {
  // No proposals on abort/shutdown ticks: the job is ending, and the
  // drain paths must not race a parameter mutation.
  if (out->abort_code != 0 || out->shutdown) return;
  ParameterManager::Proposal p;
  tuner_.Tick(std::chrono::steady_clock::now(), cur_fusion_.load(),
              static_cast<double>(cur_cycle_us_.load()) / 1000.0,
              cur_compression_.load(), cur_cross_algo_.load(), &p);
  if (!p.present) return;
  out->tuned_present = true;
  out->tuned_frozen = p.frozen;
  out->tuned_fusion_threshold = p.fusion_threshold;
  out->tuned_cycle_time_us = p.cycle_time_us;
  out->tuned_compression = static_cast<uint8_t>(p.compression);
  out->tuned_cross_algo_threshold = p.cross_algo_threshold;
  out->tuned_window = p.window;
}

void Engine::ApplyTunedParams(const ResponseList& rl) {
  // Runs on the engine thread of EVERY rank while processing the same
  // broadcast list, before this tick's cache-hit replay: the tick index
  // below is therefore identical everywhere, which is what makes the
  // applied log comparable across ranks and the fusion history a
  // deterministic function of the tick.
  int64_t tick = ticks_done_.load();
  bool comp_changed =
      cur_compression_.load() != static_cast<int64_t>(rl.tuned_compression);
  opts_.fusion_threshold = rl.tuned_fusion_threshold;
  opts_.cycle_time_ms =
      static_cast<double>(rl.tuned_cycle_time_us) / 1000.0;
  opts_.compression_mode = rl.tuned_compression;
  opts_.cross_algo_threshold = rl.tuned_cross_algo_threshold;
  cur_fusion_.store(rl.tuned_fusion_threshold);
  cur_cycle_us_.store(rl.tuned_cycle_time_us);
  cur_compression_.store(rl.tuned_compression);
  cur_cross_algo_.store(rl.tuned_cross_algo_threshold);
  if (rl.tuned_frozen) autotune_frozen_.store(true);
  applied_window_.store(rl.tuned_window);
  {
    std::lock_guard<std::mutex> lk(autotune_mu_);
    char buf[144];
    snprintf(buf, sizeof(buf), "%lld|%lld|%lld|%d|%lld|%d",
             static_cast<long long>(tick),
             static_cast<long long>(rl.tuned_fusion_threshold),
             static_cast<long long>(rl.tuned_cycle_time_us),
             static_cast<int>(rl.tuned_compression),
             static_cast<long long>(rl.tuned_cross_algo_threshold),
             rl.tuned_frozen ? 1 : 0);
    applied_log_.emplace_back(buf);
    while (applied_log_.size() > 256) applied_log_.pop_front();
    if (fusion_history_.empty() ||
        fusion_history_.back().second != rl.tuned_fusion_threshold)
      fusion_history_.emplace_back(tick, rl.tuned_fusion_threshold);
    if (compression_history_.empty() ||
        compression_history_.back().second !=
            static_cast<int64_t>(rl.tuned_compression))
      compression_history_.emplace_back(
          tick, static_cast<int64_t>(rl.tuned_compression));
    // Bounded: a pathological external policy (hvd.autotune_set per
    // phase, for hours) must not grow this without limit.  Dropping the
    // oldest change point makes the second-oldest the floor for all
    // earlier ticks — safe, because the plane only queries ticks that
    // closed recently.
    while (fusion_history_.size() > 1024) fusion_history_.pop_front();
    while (compression_history_.size() > 1024)
      compression_history_.pop_front();
  }
  timeline_.Instant("autotune",
                    rl.tuned_frozen ? "AUTOTUNE_FREEZE" : "AUTOTUNE_APPLY");
  if (flight_.Enabled()) {
    flight_.Record(FL_TUNE, "", rl.tuned_fusion_threshold);
    // Tune-style compression event (postmortem plane): straggler reports
    // must show WHICH wire format a stalled bucket was using, so mode
    // changes land in the ring next to the tick they applied at.
    if (comp_changed)
      flight_.Record(FL_COMPRESS, "", rl.tuned_compression);
  }
}

int64_t Engine::AutotuneWindows() {
  // API threads call this live; the atomic mirrors, not opts_, are the
  // reshape-safe identity (elastic reassigns opts_.rank/size mid-run on
  // the engine thread — a TSan-confirmed race when this read opts_).
  if (cur_rank_.load() == 0 || cur_size_.load() == 1)
    return tuner_.windows();
  return applied_window_.load();
}

std::string Engine::AutotuneApplied() {
  std::lock_guard<std::mutex> lk(autotune_mu_);
  std::string out;
  for (const auto& e : applied_log_) {
    if (!out.empty()) out += ';';
    out += e;
  }
  return out;
}

int Engine::AutotuneInject(int64_t fusion, double cycle_ms,
                           int64_t compression, int64_t cross_algo) {
  if (!initialized_.load()) return 2;
  if (opts_.rank != 0 && opts_.size > 1) return 1;
  tuner_.Inject(fusion, cycle_ms, compression, cross_algo);
  return 0;
}

int64_t Engine::FusionThresholdAt(int64_t tick) {
  std::lock_guard<std::mutex> lk(autotune_mu_);
  if (fusion_history_.empty()) return cur_fusion_.load();
  // Last change point at or before `tick` (the history is tiny: one
  // entry per applied threshold change).
  int64_t value = fusion_history_.front().second;
  for (const auto& e : fusion_history_) {
    if (e.first > tick) break;
    value = e.second;
  }
  return value;
}

int64_t Engine::CompressionModeAt(int64_t tick) {
  std::lock_guard<std::mutex> lk(autotune_mu_);
  if (compression_history_.empty()) return cur_compression_.load();
  int64_t value = compression_history_.front().second;
  for (const auto& e : compression_history_) {
    if (e.first > tick) break;
    value = e.second;
  }
  return value;
}

// ---------------------------------------------------------------------------
// Elastic membership (docs/fault-tolerance.md#elastic-membership).
//
// The rank-0 coordinator already OWNS membership: liveness, negotiation
// counts, and the broadcast response list all key off it.  A reshape is
// therefore just another lockstep broadcast: the coordinator ships the new
// membership (dense ranks + endpoints + the parameters the new job must
// agree on) in the response list, and every rank adopts it at the same
// tick boundary — cancelling in-flight collectives with the RETRYABLE
// ST_RESHAPE status, clearing the response cache and autotune search (so
// slot numbering and tuned params stay lockstep in the new membership),
// and rebuilding the flat data ring over the still-open listen sockets.
// ---------------------------------------------------------------------------

namespace {

std::string RankCsv(const std::vector<int32_t>& ranks) {
  std::string out;
  for (int32_t r : ranks)
    out += (out.empty() ? "" : ", ") + std::to_string(r);
  return out;
}

}  // namespace

namespace {

// Endpoints are "host:port" strings; anything past this is a corrupt or
// hostile frame length, not a real standby.
const uint32_t kMaxJoinEndpointLen = 1024;

// Incremental parse of a joiner's endpoint frame ([u32 LE length]
// [payload]) out of the bytes assembled so far.  Returns 1 with *ep
// filled when the frame is complete, 0 when more bytes are needed, and
// -1 when the bytes can never become a valid frame (zero/oversize
// length, or trailing junk after the payload).
int ParseJoinEndpointFrame(const std::vector<uint8_t>& buf,
                           std::string* ep) {
  if (buf.size() < 4) return 0;
  uint32_t len = static_cast<uint32_t>(buf[0]) |
                 (static_cast<uint32_t>(buf[1]) << 8) |
                 (static_cast<uint32_t>(buf[2]) << 16) |
                 (static_cast<uint32_t>(buf[3]) << 24);
  if (len == 0 || len > kMaxJoinEndpointLen) return -1;
  if (buf.size() < 4 + static_cast<size_t>(len)) return 0;
  if (buf.size() > 4 + static_cast<size_t>(len)) return -1;
  ep->assign(buf.begin() + 4, buf.end());
  return 1;
}

}  // namespace

bool Engine::RegisterJoiner(int fd, double timeout_sec) {
  // The joiner's hello word has been consumed; assemble its endpoint
  // frame with bounded non-blocking reads (a trickled or truncated frame
  // costs at most timeout_sec, never a blocked engine loop) and park it
  // for the next reshape barrier.
  auto deadline = std::chrono::steady_clock::now() +
                  std::chrono::duration<double>(timeout_sec);
  std::vector<uint8_t> epbuf;
  std::string ep;
  while (true) {
    if (!RecvAvailable(fd, &epbuf)) return false;
    int rc = ParseJoinEndpointFrame(epbuf, &ep);
    if (rc < 0) return false;
    if (rc > 0) break;
    double remaining = std::chrono::duration<double>(
                           deadline - std::chrono::steady_clock::now())
                           .count();
    if (remaining <= 0 || !WaitReadable(fd, remaining)) return false;
  }
  return RegisterJoinerEndpoint(fd, ep);
}

bool Engine::RegisterJoinerEndpoint(int fd, const std::string& ep) {
  // Duplicate endpoints (a standby retrying, or one colliding with a
  // LIVE member) are refused.  A dead rank's endpoint is fair game: a
  // fixed-endpoint deployment restarts the replacement on the same
  // host:port, and refusing it would crash-loop the standby while the
  // job shrinks instead of backfilling.
  bool dup = false;
  for (const auto& e : coord_->pending_join_endpoints) dup |= (e == ep);
  // rank_dead is sized by the job size; an endpoint list longer than it
  // (env-launched job with a stale HVD_TPU_DATA) counts the extras as
  // live rather than reading past the vector.
  for (size_t r = 0; r < opts_.data_endpoints.size(); ++r)
    if (r >= coord_->rank_dead.size() || !coord_->rank_dead[r])
      dup |= (opts_.data_endpoints[r] == ep);
  if (dup) return false;
  if (coord_->pending_join_fds.empty())
    coord_->join_wait_since = std::chrono::steady_clock::now();
  coord_->pending_join_fds.push_back(fd);
  coord_->pending_join_endpoints.push_back(ep);
  fprintf(stderr,
          "[horovod_tpu] standby %s registered with the coordinator; "
          "admitting at the next reshape barrier.\n",
          ep.c_str());
  return true;
}

void Engine::CoordinatorAcceptJoiners() {
  if (!opts_.elastic || coord_listen_fd_ < 0) return;
  // Drain the listen backlog without blocking (at most a few per tick).
  // The handshake itself is deferred: a standby sends hello+endpoint
  // immediately after connect, so its fd turns readable within a tick,
  // while a non-joiner connect that never sends (port scanner, health
  // check, load-balancer probe) parks in `handshaking` at zero cost to
  // the tick and is dropped at its deadline — it must not be able to
  // stall every worker's negotiation wait behind a blocking read.
  for (int accepted = 0; accepted < 4 && WaitReadable(coord_listen_fd_, 0.0);
       ++accepted) {
    std::string err;
    int fd = AcceptOne(coord_listen_fd_, 0.0, &err);
    if (fd < 0) break;
    coord_->handshaking.push_back(
        {fd, std::chrono::steady_clock::now() + std::chrono::seconds(5)});
  }
  for (size_t i = coord_->handshaking.size(); i-- > 0;) {
    auto& hs = coord_->handshaking[i];
    // Assemble the hello + endpoint frame strictly from bytes already in
    // the kernel buffer: a peer that trickles a partial handshake parks
    // here until its deadline and can never block the tick mid-message.
    bool settled = false;
    if (!RecvAvailable(hs.fd, &hs.buf)) {
      settled = true;  // EOF or socket error before a full handshake
      CloseFd(hs.fd);
    } else {
      uint32_t hello = 0;
      if (hs.buf.size() >= 4) memcpy(&hello, hs.buf.data(), 4);
      if (hs.buf.size() >= 4 && hello != kJoinHello) {
        settled = true;  // not a joiner (probe, scanner, stale connect)
        CloseFd(hs.fd);
      } else if (hs.buf.size() >= 4) {
        std::string ep;
        std::vector<uint8_t> frame(hs.buf.begin() + 4, hs.buf.end());
        int rc = ParseJoinEndpointFrame(frame, &ep);
        if (rc != 0) {
          settled = true;
          if (rc < 0 || !RegisterJoinerEndpoint(hs.fd, ep))
            CloseFd(hs.fd);
        }
      }
    }
    if (!settled && std::chrono::steady_clock::now() >= hs.deadline) {
      settled = true;
      CloseFd(hs.fd);
    }
    if (settled)
      coord_->handshaking.erase(coord_->handshaking.begin() + i);
  }
}

bool Engine::CoordinatorMaybeReshape(ResponseList* out) {
  if (!opts_.elastic || out->abort_code != 0 || out->shutdown) return false;
  // Sweep joiners that died while waiting for admission: broadcasting a
  // dead standby's endpoint would send every survivor's RebuildRing
  // chasing a closed port and turn a healthy elastic job into a fatal
  // abort.  (A joiner has nothing to send after registering, so any
  // readable state here is EOF/error.)
  for (size_t i = coord_->pending_join_fds.size(); i-- > 0;) {
    if (!PeerClosed(coord_->pending_join_fds[i])) continue;
    fprintf(stderr,
            "[horovod_tpu] standby %s died before admission; dropped.\n",
            coord_->pending_join_endpoints[i].c_str());
    CloseFd(coord_->pending_join_fds[i]);
    coord_->pending_join_fds.erase(coord_->pending_join_fds.begin() + i);
    coord_->pending_join_endpoints.erase(
        coord_->pending_join_endpoints.begin() + i);
  }
  bool shrink = coord_->reshape_pending;
  // A grow-only barrier waits for a quiesced tick (nothing pending or
  // broadcast this tick, and the previous reshape acknowledged) so the
  // interruption is limited to the enqueue-poison handshake; a shrink
  // barrier fires immediately — everything in flight is doomed anyway.
  bool grow = !shrink && !coord_->pending_join_fds.empty() &&
              coord_->message_table.empty() &&
              coord_->cache_pending.empty() && out->responses.empty() &&
              out->cache_hits.empty() && !reshape_ack_pending_.load();
  if (!shrink && !grow && !coord_->pending_join_fds.empty() &&
      !reshape_ack_pending_.load()) {
    // A fully pipelined loop (async enqueues keeping every tick busy)
    // may never present a quiesced tick; past a bounded wait, force the
    // barrier so admission cannot starve — the standby's own admission
    // timeout (120s in SetupRejoinSockets) is the backstop this must
    // beat.  In-flight collectives get the retryable ST_RESHAPE exactly
    // as in a shrink.
    constexpr double kForcedGrowSec = 10.0;
    double waited = std::chrono::duration<double>(
                        std::chrono::steady_clock::now() -
                        coord_->join_wait_since)
                        .count();
    if (waited >= kForcedGrowSec) {
      fprintf(stderr,
              "[horovod_tpu] standby waited %.1fs without a quiesced "
              "tick; forcing the grow barrier (in-flight collectives "
              "will retry in the new membership).\n",
              waited);
      grow = true;
    }
  }
  if (!shrink && !grow) return false;
  // The reshape replaces this tick's payload: op responses built against
  // the old membership would execute over a ring a dead rank just broke,
  // and cache hits would replay against caches the barrier is clearing.
  out->responses.clear();
  out->cache_hits.clear();
  out->tuned_present = false;
  out->reshape_present = true;
  out->membership_epoch = membership_epoch_.load() + 1;
  out->reshape_cache_capacity = opts_.cache_capacity;
  out->reshape_fusion_threshold = cur_fusion_.load();
  out->reshape_cycle_time_us = cur_cycle_us_.load();
  out->reshape_compression = static_cast<uint8_t>(cur_compression_.load());
  out->reshape_compression_min_bytes = opts_.compression_min_bytes;
  out->reshape_cross_algo_threshold = cur_cross_algo_.load();
  for (int r = 0; r < opts_.size; ++r) {
    if (coord_->rank_dead[r]) {
      out->reshape_lost.push_back(r);
      continue;
    }
    out->member_old_ranks.push_back(r);
    out->member_endpoints.push_back(opts_.data_endpoints[r]);
  }
  for (const auto& ep : coord_->pending_join_endpoints) {
    out->member_old_ranks.push_back(-1);
    out->member_endpoints.push_back(ep);
  }
  return true;
}

bool Engine::ApplyReshape(const ResponseList& rl) {
  int old_rank = opts_.rank;
  int old_size = opts_.size;
  int new_size = static_cast<int>(rl.member_old_ranks.size());
  int new_rank = -1;
  std::vector<int32_t> joined;
  for (int i = 0; i < new_size; ++i) {
    if (rl.member_old_ranks[i] == old_rank) new_rank = i;
    if (rl.member_old_ranks[i] < 0) joined.push_back(i);
  }
  if (new_rank < 0) {
    // Unreachable for a live rank (the coordinator only reshapes around
    // survivors it is still talking to); fail closed rather than run
    // with a wrong identity.
    AbortLocal(ST_RANKS_DOWN,
               "membership reshape did not include this rank; the job "
               "cannot continue and should be restarted.");
    return false;
  }
  std::string msg =
      "membership changed (epoch " +
      std::to_string(static_cast<long long>(rl.membership_epoch)) + "): " +
      (rl.reshape_lost.empty()
           ? std::string("rank(s) joined")
           : "ranks down: " + RankCsv(rl.reshape_lost)) +
      "; continuing with " + std::to_string(new_size) +
      " rank(s).  In-flight collectives were cancelled; re-enter "
      "agreement and resync state from the root (hvd.run_elastic does "
      "both).";

  // 1. Arm the enqueue poison BEFORE draining: an Enqueue that misses the
  // flag must have entered the table before the drain below (both hold
  // mu_), so every in-flight or racing collective gets the retryable
  // status — none can slip through into the new membership's negotiation
  // before Python acknowledges (hvd.membership_ack / run_elastic resync).
  {
    std::lock_guard<std::mutex> lk(membership_mu_);
    reshape_message_ = msg;
    for (int32_t r : rl.reshape_lost) ranks_lost_.push_back(r);
    for (int32_t r : joined) ranks_joined_.push_back(r);
  }
  reshape_ack_pending_.store(true);
  // 2. Cancel everything in flight with the retryable status.  Entries
  // already failed by a broken ring carry their transport error instead;
  // the elastic driver treats both as retryable once the epoch bumps.
  std::vector<TableEntry> doomed;
  {
    std::lock_guard<std::mutex> lk(mu_);
    for (auto& kv : table_) doomed.push_back(std::move(kv.second));
    table_.clear();
    queue_.clear();
  }
  for (auto& e : doomed) CompleteEntry(e, ST_RESHAPE, msg);
  // 3. Caches and the autotune search reset at the barrier, on every
  // rank at the same tick: slot numbering and tuned parameters must mean
  // the same thing everywhere in the new membership.
  opts_.cache_capacity = rl.reshape_cache_capacity;
  cache_.set_capacity(opts_.cache_capacity);
  cache_.Clear();
  cache_size_.store(0);
  opts_.fusion_threshold = rl.reshape_fusion_threshold;
  opts_.cycle_time_ms =
      static_cast<double>(rl.reshape_cycle_time_us) / 1000.0;
  cur_fusion_.store(rl.reshape_fusion_threshold);
  cur_cycle_us_.store(rl.reshape_cycle_time_us);
  // Wire compression re-agrees across the barrier: every member — the
  // admitted standbys included, whose own env never went through the
  // init-time equality check — adopts the broadcast mode and floor, and
  // the error-feedback residuals reset (the membership, and with it
  // every sum a residual was correcting toward, just changed).
  opts_.compression_mode = rl.reshape_compression;
  opts_.compression_min_bytes = rl.reshape_compression_min_bytes;
  cur_compression_.store(rl.reshape_compression);
  cur_comp_min_bytes_.store(rl.reshape_compression_min_bytes);
  // The ring-vs-tree boundary re-agrees like the other tuned axes, so
  // the applied-parameter view stays identical across the barrier (the
  // knob itself is dormant until a topology is rebuilt hierarchical).
  opts_.cross_algo_threshold = rl.reshape_cross_algo_threshold;
  cur_cross_algo_.store(rl.reshape_cross_algo_threshold);
  residuals_.clear();
  residual_bytes_.store(0);
  residual_tensors_.store(0);
  autotune_frozen_.store(false);
  applied_window_.store(0);
  // A stale steady-exit marker must not cross the barrier: it would
  // report miss coordinates in a pattern whose slots the cache clear
  // above just renumbered.  (Steady replay itself cannot be active here
  // — every path into ApplyReshape exits steady first.)
  steady_exit_pending_ = false;
  {
    std::lock_guard<std::mutex> lk(autotune_mu_);
    applied_log_.clear();
    fusion_history_.clear();
    fusion_history_.emplace_back(ticks_done_.load(),
                                 rl.reshape_fusion_threshold);
    compression_history_.clear();
    compression_history_.emplace_back(
        ticks_done_.load(), static_cast<int64_t>(rl.reshape_compression));
  }
  // 4. Adopt the new identity.  Elastic jobs are single-host (the
  // launcher rejects --hosts), so the local identity tracks the global
  // one — a survivor and an admitted standby must never collide on
  // local_rank() for per-host resources.
  opts_.rank = new_rank;
  opts_.size = new_size;
  opts_.local_rank = new_rank;
  opts_.local_size = new_size;
  opts_.data_endpoints.assign(rl.member_endpoints.begin(),
                              rl.member_endpoints.end());
  cur_rank_.store(new_rank);
  cur_size_.store(new_size);
  cur_local_rank_.store(new_rank);
  cur_local_size_.store(new_size);
  membership_epoch_.store(rl.membership_epoch);
  reshapes_total_.fetch_add(1);
  // 5. Coordinator bookkeeping: compact the control star to the new
  // membership (survivor fds keep their sockets, admitted standbys bring
  // theirs) and restart the per-rank liveness/search state.
  if (old_rank == 0 && coord_) {
    std::vector<int> new_fds(new_size, -1);
    int join_i = 0;
    for (int i = 0; i < new_size; ++i) {
      int prev = rl.member_old_ranks[i];
      if (prev == 0) continue;  // self
      if (prev > 0 && prev < static_cast<int>(coord_fds_.size())) {
        new_fds[i] = coord_fds_[prev];
        coord_fds_[prev] = -1;
      } else if (prev < 0 &&
                 join_i < static_cast<int>(coord_->pending_join_fds.size())) {
        new_fds[i] = coord_->pending_join_fds[join_i++];
      }
    }
    for (int fd : coord_fds_) CloseFd(fd);  // dead ranks' sockets
    coord_fds_ = std::move(new_fds);
    // Elastic jobs run the one-level star: every worker is a direct
    // child of the rebuilt coordinator.
    coord_children_.clear();
    for (int r = 1; r < new_size; ++r) coord_children_.push_back(r);
    ctrl_children_.store(new_size - 1);
    coord_->pending_join_fds.clear();
    coord_->pending_join_endpoints.clear();
    coord_->rank_dead.assign(new_size, false);
    // Post-reshape postmortem accounting restarts: old entries carry the
    // previous membership's rank numbering.
    coord_->last_frame_tick.assign(new_size, -1);
    coord_->last_announce_tick.assign(new_size, -1);
    coord_->last_announce_name.assign(new_size, "");
    coord_->reshape_pending = false;
    coord_->message_table.clear();
    coord_->ready.clear();
    coord_->cache_pending.clear();
    coord_->cached_ready.clear();
    // Steady-state bookkeeping resets with the membership: the old
    // pattern named cache slots the clear above renumbered, and the
    // exit-barrier accounting must match the new size.
    coord_->steady = false;
    coord_->steady_revoke_next = false;
    coord_->steady_exited.assign(new_size, false);
    coord_->slot_history.clear();
    // Reshapes force the flat ring, so the cross-algo axis pins (the
    // knob is dead in the new membership).
    tuner_.Configure(opts_.autotune, opts_.autotune_warmup,
                     opts_.autotune_window, opts_.autotune_fix_fusion,
                     opts_.autotune_fix_cycle_ms,
                     opts_.compression_mode == COMP_NONE
                         ? COMP_NONE
                         : opts_.autotune_fix_compression,
                     opts_.cross_algo_threshold,
                     opts_.fusion_threshold, opts_.cycle_time_ms,
                     opts_.compression_mode, opts_.cross_algo_threshold);
    std::lock_guard<std::mutex> lk(announce_mu_);
    if (static_cast<int>(last_announce_counts_.size()) < new_size)
      last_announce_counts_.resize(new_size, 0);
  }
  // 6. Rebuild the data plane for the new membership.  A clean rebuild
  // also clears the broken-transport latch a mid-collective death set.
  std::string err;
  if (!RebuildRing(&err)) {
    AbortLocal(ST_RANKS_DOWN,
               "membership reshape failed while rebuilding the data ring "
               "(" + err + "); this job cannot continue and should be "
               "restarted.");
    return false;
  }
  data_plane_failed_.store(false);
  if (flight_.Enabled())
    flight_.Record(FL_RESHAPE, "", rl.membership_epoch);
  timeline_.Instant("membership", "MEMBERSHIP_RESHAPE");
  std::string how = rl.reshape_lost.empty()
                        ? std::string(" (grow)")
                        : " (lost rank(s) " + RankCsv(rl.reshape_lost) + ")";
  fprintf(stderr,
          "[horovod_tpu] membership epoch %lld: rank %d/%d -> %d/%d%s.\n",
          static_cast<long long>(rl.membership_epoch), old_rank, old_size,
          new_rank, new_size, how.c_str());
  return true;
}

bool Engine::RebuildRing(std::string* err) {
  // Quiesce the heartbeat monitor for the rebuild: clear the wake
  // registry FIRST (the fds it lists are about to be closed), then move
  // the old beat sockets to the graveyard — ShutdownFd kicks the monitor
  // out of any blocking poll on them, and it closes the fds itself on
  // its next pass after re-reading the swapped state (closing here would
  // race fd reuse against its poll set).
  {
    std::lock_guard<std::mutex> lk(hb_mu_);
    hb_wake_fds_.clear();
    hb_ctrl_wake_fd_ = -1;
    if (beat_in_fd_ >= 0) {
      ShutdownFd(beat_in_fd_);
      hb_graveyard_.push_back(beat_in_fd_);
    }
    if (beat_out_fd_ >= 0) {
      ShutdownFd(beat_out_fd_);
      hb_graveyard_.push_back(beat_out_fd_);
    }
    beat_in_fd_ = beat_out_fd_ = -1;
    beat_in_peer_ = beat_out_peer_ = -1;
    hb_last_seen_us_.clear();
    hb_miss_counts_.clear();
    pending_hb_dead_.clear();
    pending_hb_report_.clear();
  }
  CloseFd(left_fd_);
  CloseFd(right_fd_);
  left_fd_ = right_fd_ = -1;
  left_ch_ = Channel{};
  right_ch_ = Channel{};
  // Elastic jobs run the flat ring only; make sure no stale two-level
  // topology outlives a reshape.
  CloseTopologyFds();
  // Dedicated p2p channels name ranks of the OLD membership; drop them
  // and let the new membership redial lazily.
  CloseP2pChannels();
  node_id_ = 0;
  n_nodes_ = 1;
  topo_hier_.store(false);
  topo_nodes_.store(1);
  if (opts_.size == 1) return true;  // monitor idles on fd==-1
  const double kTimeout = 30.0;
  // Epoch-tagged hellos: a stale connect from a previous membership (or
  // a dying rank's last SYN in the backlog) parses as a mismatch and is
  // dropped instead of being adopted as a neighbour.
  const uint32_t epoch_tag =
      static_cast<uint32_t>(membership_epoch_.load() & 0xff) << 16;
  uint32_t hello = (3u << 24) | epoch_tag |
                   (static_cast<uint32_t>(opts_.rank) & 0xffff);
  int right = (opts_.rank + 1) % opts_.size;
  const int beat_left = (opts_.rank + opts_.size - 1) % opts_.size;
  const bool want_beats = hb_interval_ms_ > 0;
  std::string host;
  int port;
  if (!ParseEndpoint(opts_.data_endpoints[right], &host, &port)) {
    *err = "bad data endpoint " + opts_.data_endpoints[right];
    return false;
  }
  right_fd_ = ConnectRetry(host, port, kTimeout, err);
  if (right_fd_ < 0) return false;
  if (!SendAll(right_fd_, &hello, 4)) {
    *err = "ring-rebuild hello send failed";
    return false;
  }
  // The beacon lane rebuilds with the ring, epoch-tagged the same way.
  int new_beat_out = -1;
  int new_beat_in = -1;
  if (want_beats) {
    uint32_t beat_hello = (6u << 24) | epoch_tag |
                          (static_cast<uint32_t>(opts_.rank) & 0xffff);
    new_beat_out = ConnectRetry(host, port, kTimeout, err);
    if (new_beat_out < 0) return false;
    if (!SendAll(new_beat_out, &beat_hello, 4)) {
      CloseFd(new_beat_out);
      *err = "beacon rebuild hello send failed";
      return false;
    }
  }
  for (int attempts = 0;
       attempts < 32 && (left_fd_ < 0 || (want_beats && new_beat_in < 0));
       ++attempts) {
    int fd = AcceptOne(data_listen_fd_, kTimeout, err);
    if (fd < 0) {
      if (new_beat_out >= 0 && beat_out_fd_ != new_beat_out)
        CloseFd(new_beat_out);
      return false;
    }
    uint32_t peer = 0;
    if (!WaitReadable(fd, 2.0) || !RecvAll(fd, &peer, 4)) {
      CloseFd(fd);
      continue;
    }
    if ((peer & 0x00ff0000u) != epoch_tag) {
      CloseFd(fd);  // stale pre-reshape connect
      continue;
    }
    uint32_t kind = peer >> 24;
    if (kind == 3 && left_fd_ < 0) {
      left_fd_ = fd;
    } else if (kind == 6 && want_beats && new_beat_in < 0 &&
               (peer & 0xffffu) == static_cast<uint32_t>(beat_left)) {
      new_beat_in = fd;
    } else {
      CloseFd(fd);
    }
  }
  if (left_fd_ < 0 || (want_beats && new_beat_in < 0)) {
    if (new_beat_in >= 0) CloseFd(new_beat_in);
    if (new_beat_out >= 0) CloseFd(new_beat_out);
    *err = left_fd_ < 0
               ? "ring left neighbour never connected after the reshape"
               : "heartbeat beacon left neighbour never reconnected "
                 "after the reshape";
    return false;
  }
  // Unconditional (like SetupSockets): the link telemetry rides the same
  // fd -> peer registry as the fault clauses.
  NetFaultRegister(right_fd_, right);
  NetFaultRegister(left_fd_, beat_left);
  if (want_beats) {
    NetFaultRegister(new_beat_out, right);
    NetFaultRegister(new_beat_in, beat_left);
  }
  // Swap the new beacon lane in and re-arm the detector for the new
  // membership in one atomic step (the monitor re-reads everything from
  // hb_mu_-guarded state each pass).
  {
    std::lock_guard<std::mutex> lk(hb_mu_);
    beat_out_fd_ = new_beat_out;
    beat_out_peer_ = want_beats ? right : -1;
    beat_in_fd_ = new_beat_in;
    beat_in_peer_ = want_beats ? beat_left : -1;
    hb_epoch_ = static_cast<int>(membership_epoch_.load() & 0xff);
    int64_t now = EpochNowUs();
    if (want_beats) {
      hb_last_seen_us_[right] = now;
      hb_last_seen_us_[beat_left] = now;
    }
    hb_wake_fds_.push_back(left_fd_);
    hb_wake_fds_.push_back(right_fd_);
    hb_ctrl_wake_fd_ = opts_.rank == 0 ? -1 : coord_fd_;
  }
  // Re-wrap the rebuilt ring in channels (elastic jobs run TCP-only —
  // the shm agreement excludes them — so no rings to re-attach).
  left_ch_ = Channel{left_fd_, nullptr, nullptr, beat_left};
  right_ch_ = Channel{right_fd_, nullptr, nullptr, right};
  return true;
}

bool Engine::SetupRejoinSockets(std::string* err) {
  // Standby bring-up: listen on our own data endpoint, register with the
  // coordinator, and block until the admitting reshape broadcast names
  // our dense rank and the full membership.
  const double kTimeout = 120.0;
  if (opts_.data_endpoints.empty() || opts_.coord_endpoint.empty()) {
    *err = "rejoin requires HVD_TPU_COORD and this rank's HVD_TPU_DATA";
    return false;
  }
  std::string my_ep = opts_.data_endpoints[0];
  std::string host;
  int port;
  if (!ParseEndpoint(my_ep, &host, &port)) {
    *err = "bad data endpoint " + my_ep;
    return false;
  }
  data_listen_fd_ = Listen("0.0.0.0", port, err);
  if (data_listen_fd_ < 0) return false;
  if (!ParseEndpoint(opts_.coord_endpoint, &host, &port)) {
    *err = "bad coordinator endpoint " + opts_.coord_endpoint;
    return false;
  }
  coord_fd_ = ConnectRetry(host, port, kTimeout, err);
  if (coord_fd_ < 0) return false;
  if (!SendAll(coord_fd_, &kJoinHello, 4) ||
      !SendFrame(coord_fd_,
                 std::vector<uint8_t>(my_ep.begin(), my_ep.end()))) {
    *err = "rejoin registration send failed";
    return false;
  }
  if (!WaitReadable(coord_fd_, kTimeout)) {
    *err = "rejoin admission timed out (no reshape barrier within " +
           std::to_string(static_cast<long long>(kTimeout)) + "s)";
    return false;
  }
  std::vector<uint8_t> buf;
  ResponseList rl;
  if (!RecvFrame(coord_fd_, &buf) || !ParseResponseList(buf, &rl) ||
      !rl.reshape_present) {
    *err = "rejoin admission failed (coordinator closed or sent a "
           "non-reshape frame)";
    return false;
  }
  int new_rank = -1;
  for (size_t i = 0; i < rl.member_endpoints.size(); ++i)
    if (rl.member_old_ranks[i] < 0 && rl.member_endpoints[i] == my_ep)
      new_rank = static_cast<int>(i);
  if (new_rank < 0) {
    *err = "rejoin admission did not include this standby's endpoint";
    return false;
  }
  opts_.rank = new_rank;
  opts_.size = static_cast<int>(rl.member_old_ranks.size());
  // Single-host elastic: local identity tracks global (see ApplyReshape).
  opts_.local_rank = new_rank;
  opts_.local_size = opts_.size;
  opts_.data_endpoints.assign(rl.member_endpoints.begin(),
                              rl.member_endpoints.end());
  opts_.cache_capacity = rl.reshape_cache_capacity;
  opts_.fusion_threshold = rl.reshape_fusion_threshold;
  opts_.cycle_time_ms =
      static_cast<double>(rl.reshape_cycle_time_us) / 1000.0;
  // Wire compression comes from the admitting broadcast, not this
  // standby's env: the live job's agreement wins.  Same for the
  // cross-algo boundary (Init stores cur_cross_algo_ from opts_ after
  // this returns, like fusion/cycle).
  opts_.compression_mode = rl.reshape_compression;
  opts_.compression_min_bytes = rl.reshape_compression_min_bytes;
  opts_.cross_algo_threshold = rl.reshape_cross_algo_threshold;
  cur_compression_.store(rl.reshape_compression);
  cur_comp_min_bytes_.store(rl.reshape_compression_min_bytes);
  cur_rank_.store(new_rank);
  cur_size_.store(opts_.size);
  membership_epoch_.store(rl.membership_epoch);
  {
    std::lock_guard<std::mutex> lk(membership_mu_);
    ranks_joined_.push_back(new_rank);
    for (int32_t r : rl.reshape_lost) ranks_lost_.push_back(r);
  }
  fprintf(stderr,
          "[horovod_tpu] standby admitted as rank %d/%d (membership epoch "
          "%lld).\n",
          new_rank, opts_.size,
          static_cast<long long>(rl.membership_epoch));
  // No clock sync for standbys: the admitting barrier cannot stall the
  // live job on probe round-trips; this rank's timeline keeps offset 0.
  return RebuildRing(err);
}

std::string Engine::MembershipInfo() {
  std::lock_guard<std::mutex> lk(membership_mu_);
  return std::to_string(static_cast<long long>(membership_epoch_.load())) +
         "|" + std::to_string(cur_size_.load()) + "|" +
         RankCsv(ranks_lost_) + "|" + RankCsv(ranks_joined_);
}

// ---------------------------------------------------------------------------
// Execution.
// ---------------------------------------------------------------------------

void Engine::ProcessCacheHits(const std::vector<uint32_t>& hits) {
  if (hits.empty()) return;
  // Replay the stored responses in broadcast order, re-fusing consecutive
  // same-dtype allreduces under the threshold exactly like the
  // coordinator fuses fresh negotiations — steady-state repeats keep
  // their one-ring-pass-per-bucket behavior.
  std::vector<Response> merged;
  std::vector<int64_t> merged_bytes;
  std::vector<uint8_t> merged_dtypes;
  uint8_t fused_dtype = 255;
  for (uint32_t hit : hits) {
    const CacheSlot* s = cache_.Get(static_cast<int>(hit));
    if (s == nullptr) continue;  // unreachable with lockstep caches
    // Broadcast-driven LRU touch: identical order on every rank, so
    // eviction decisions stay in lockstep.
    cache_.Touch(static_cast<int>(hit));
    int64_t bytes =
        NumElements(s->dims) * static_cast<int64_t>(DataTypeSize(s->dtype));
    if (s->response.type == RESP_ALLREDUCE &&
        s->response.stage_ranks.empty() && !merged.empty() &&
        FusesInto(merged.back(), merged_bytes.back(), fused_dtype, s->dtype,
                  bytes, opts_.fusion_threshold)) {
      merged.back().names.push_back(s->name);
      merged_bytes.back() += bytes;
    } else {
      merged.push_back(s->response);
      merged_bytes.push_back(bytes);
      merged_dtypes.push_back(s->dtype);
      fused_dtype = s->dtype;
    }
  }
  // Replayed buckets recompute the wire-compression verdict locally from
  // the same inputs the coordinator would use — bucket dtype/bytes (from
  // the broadcast hit order) and the lockstep-mutated (mode, min-bytes)
  // state — so a replayed bucket compresses exactly like its fresh
  // negotiation would, on every rank, without putting the verdict back on
  // the wire.
  // (RESP_SENDRECV slots replay their stored verdict verbatim — p2p
  // never re-fuses — and stage-scoped allreduces never compress.)
  for (size_t i = 0; i < merged.size(); ++i)
    if (merged[i].type == RESP_ALLREDUCE && merged[i].stage_ranks.empty())
      merged[i].compression =
          ChooseCompression(merged_dtypes[i], merged_bytes[i]);
  for (const auto& resp : merged) PerformOperation(resp, /*from_cache=*/true);
}

void Engine::PerformOperation(const Response& resp, bool from_cache) {
  std::vector<TableEntry> entries;
  auto arrived = std::chrono::steady_clock::now();
  {
    std::lock_guard<std::mutex> lk(mu_);
    for (const auto& name : resp.names) {
      auto it = table_.find(name);
      if (it == table_.end()) continue;  // should not happen
      entries.push_back(std::move(it->second));
      table_.erase(it);
    }
  }
  if (resp.type == RESP_ERROR && cache_.enabled()) {
    // A name that negotiated to an error must renegotiate from scratch:
    // drop any stale agreement so later (consistent) reuse is a clean
    // miss, not a replay of dead metadata.  Driven by resp.names alone —
    // NOT the local entries — so even a rank that never submitted this
    // round (a poison-window straggler scenario) evicts in lockstep.
    for (const auto& name : resp.names) cache_.Erase(name);
    cache_size_.store(cache_.size());
  }
  // Partial-participation agreements (p2p pairs, stage-scoped
  // collectives) mutate the cache from the RESPONSE metadata, before the
  // no-local-entry return below: most ranks never enqueued the name, yet
  // every cache must Put the slot at this list position or slot indices
  // diverge and the next cache-bit announce is garbage (docs/pipeline.md
  // #steady-state).  The slot is byte-identical on every rank (canonical
  // op + the broadcast signature); Lookup restores the per-rank role.
  if (cache_.enabled() && !from_cache &&
      (resp.type == RESP_SENDRECV ||
       (resp.type == RESP_ALLREDUCE && !resp.stage_ranks.empty()))) {
    Response single = resp;  // p2p/stage responses are never fused
    CacheSlot evicted;
    uint8_t slot_op = resp.type == RESP_SENDRECV
                          ? static_cast<uint8_t>(OP_SEND)
                          : static_cast<uint8_t>(OP_ALLREDUCE);
    int slot = cache_.Put(resp.names[0], slot_op, resp.p2p_dtype,
                          resp.p2p_dims, -1, single, &evicted);
    if (evicted.valid) {
      cache_evictions_.fetch_add(1);
      CoordinatorDrainSlot(slot, evicted);
    }
    cache_size_.store(cache_.size());
  }
  if (entries.empty()) return;
  // Negotiation latency stamp (negotiation_sec histogram, both planes):
  // enqueue -> the agreed response reaching this rank, before execution.
  for (auto& e : entries)
    e.negotiation_us = std::chrono::duration_cast<std::chrono::microseconds>(
                           arrived - e.enqueued_at)
                           .count();

  if (flight_.Enabled() && !resp.names.empty())
    flight_.Record(resp.type == RESP_ERROR ? FL_ERROR : FL_EXECUTE,
                   resp.names[0], static_cast<int64_t>(resp.names.size()));
  if (resp.type == RESP_ERROR) {
    for (auto& e : entries) CompleteEntry(e, ST_PRECONDITION, resp.error_message);
    return;
  }
  if (cache_.enabled() && !from_cache && resp.type != RESP_SENDRECV &&
      (resp.type != RESP_ALLREDUCE || resp.stage_ranks.empty())) {
    // Freshly negotiated: store each name's agreement so its next
    // signature-identical submission announces a compact cache bit.
    // Slot assignment and LRU order are driven by the broadcast list —
    // lockstep on every rank.  (p2p / stage-scoped responses stored
    // above, from metadata, on every rank.)
    for (auto& e : entries) {
      Response single;
      single.type = resp.type;
      single.names.push_back(e.name);
      single.rank_dim0 = resp.rank_dim0;
      // Deliberately NOT the bucket's compression verdict: replays
      // re-fuse and recompute it from the replayed bucket's size
      // (ProcessCacheHits), so a stale per-name copy would only mislead.
      single.compression = COMP_NONE;
      CacheSlot evicted;
      int slot = cache_.Put(e.name, e.op, e.dtype, e.dims, e.root_rank,
                            single, &evicted);
      if (evicted.valid) {
        cache_evictions_.fetch_add(1);
        // Rank 0: bits still pending against the evicted entry can no
        // longer be matched by index — convert them back to full
        // requests so their negotiation completes by name.
        CoordinatorDrainSlot(slot, evicted);
      }
    }
    cache_size_.store(cache_.size());
  }
  if (data_plane_failed_.load()) {
    for (auto& e : entries)
      CompleteEntry(e, ST_ABORTED,
                    "the data plane failed during an earlier collective "
                    "(a rank died or a transport broke); this job cannot "
                    "make progress and should be restarted.");
    return;
  }
  switch (resp.type) {
    case RESP_ALLREDUCE:
      if (!resp.stage_ranks.empty())
        ExecuteGroupAllreduce(resp, entries);
      else
        ExecuteAllreduce(resp, entries);
      break;
    case RESP_SENDRECV:
      ExecuteSendRecv(resp, entries[0]);
      break;
    case RESP_ALLGATHER:
      ExecuteAllgather(resp, entries[0]);
      break;
    case RESP_BROADCAST:
      ExecuteBroadcast(resp, entries[0]);
      break;
    case RESP_NOOP:
      // Negotiation-only (the XLA plane's cached metadata agreement): the
      // completion stamp IS the payload — no data moves.
      for (auto& e : entries) CompleteEntry(e, ST_OK, "");
      break;
    default:
      for (auto& e : entries)
        CompleteEntry(e, ST_UNKNOWN, "unknown response type");
  }
}

void Engine::ExecuteAllreduce(const Response& resp,
                              std::vector<TableEntry>& entries) {
  uint8_t dtype = entries[0].dtype;
  bool half = (dtype == HVD_FLOAT16 || dtype == HVD_BFLOAT16);
  bool hier = opts_.hierarchical_allreduce && opts_.size > 1;
  // Negotiated wire compression (the Response's per-bucket verdict)
  // applies to fp32 payloads on the flat ring AND on the two-level
  // topology's cross-node (DCN) hop — the hop where bytes cost money.
  uint8_t comp = (dtype == HVD_FLOAT32) ? resp.compression : COMP_NONE;
  // Wire format for the f32-master paths: a lossy compressed format for
  // fp32 buckets, or the payload's OWN width for f16/bf16 (halves ship
  // native-width on the flat ring and on BOTH hops of the two-level
  // topology) — 255 = plain wire in the payload dtype.  Reduction
  // accumulates in f32 at each hop in all wire modes.
  uint8_t wire = 255;
  if (comp == COMP_BF16)
    wire = WIRE_BF16;
  else if (comp == COMP_FP8)
    wire = WIRE_FP8;
  else if (half)
    wire = dtype == HVD_FLOAT16 ? WIRE_F16 : WIRE_BF16;
  size_t esize = DataTypeSize(dtype);

  int64_t total_elems = 0;
  for (auto& e : entries) total_elems += NumElements(e.dims);
  for (auto& e : entries) timeline_.Start(e.name, "ALLREDUCE");

  // Two-level cross-node algorithm selection (per bucket, lockstep: the
  // threshold is broadcast tuned state and the bucket size follows the
  // lockstep fusion plan, so every rank flips ring<->tree at the same
  // bucket).  Latency-bound small buckets take the recursive-doubling
  // tree; bandwidth-bound big ones the ring.
  bool use_tree = false;
  if (hier && n_nodes_ > 1) {
    int64_t bucket_bytes = total_elems * static_cast<int64_t>(esize);
    use_tree = !cross_tree_fds_.empty() &&
               bucket_bytes < cur_cross_algo_.load();
    (use_tree ? topo_ops_tree_ : topo_ops_ring_).fetch_add(1);
    int algo = use_tree ? 1 : 0;
    int last = topo_last_algo_.exchange(algo);
    if (last != -1 && last != algo && flight_.Enabled())
      flight_.Record(FL_TOPOLOGY, entries[0].name, algo);
  }

  // Compression metrics: every executed bucket records its payload width
  // and its wire width (on the two-level topology: the cross/DCN hop's
  // width), so wire_bytes/payload_bytes exposes both the compression win
  // and any residual staging inflation (native halves: wire == payload).
  int64_t wire_unit = wire != 255 ? static_cast<int64_t>(WireFormatSize(wire))
                                  : static_cast<int64_t>(esize);
  RecordCompressedOp(entries[0].name, comp,
                     total_elems * static_cast<int64_t>(esize),
                     total_elems * wire_unit);

  std::string err;
  bool ok = true;
  const char* reduce_activity =
      hier ? "HIERARCHICAL_ALLREDUCE" : "RING_ALLREDUCE";
  auto do_allreduce = [&](void* buf, int64_t n, std::string* e) {
    return hier ? TwoLevelAllreduce(buf, n, dtype, 255, 255, use_tree,
                                    entries[0].name, e)
                : RingAllreduce(buf, n, dtype, e);
  };
  if (wire != 255 || (hier && dtype == HVD_FLOAT32)) {
    // Compressed / native-width wire path: fp32 master copies live in the
    // fusion buffer, segments cross the wire narrowed.  For lossy fp32
    // compression each tensor carries an error-feedback residual: the
    // quantization error of THIS step's (input + residual) is saved and
    // added back in before the next step's compression (1-bit-SGD-style
    // error feedback), so the wire rounding never compounds into drift.
    last_fusion_use_ = std::chrono::steady_clock::now();
    if (fusion_buffer_.size() < static_cast<size_t>(total_elems) * 4)
      fusion_buffer_.resize(static_cast<size_t>(total_elems) * 4);
    float* fb = reinterpret_cast<float*>(fusion_buffer_.data());
    bool ef = comp != COMP_NONE;  // native half payloads are already
                                  // wire-exact; no residual needed
    if (ef) {
      // Residual-map bound: a stream of never-repeating auto-named
      // tensors gains nothing from error feedback but would grow this
      // forever.  Checked ONCE, before this bucket touches the map — a
      // mid-bucket clear would discard residuals just stored for the
      // bucket's earlier tensors in this very step.
      size_t fresh = 0;
      for (auto& e : entries)
        if (!residuals_.count(e.name)) ++fresh;
      if (fresh > 0 && residuals_.size() + fresh > 4096) {
        residuals_.clear();
        residual_bytes_.store(0);
      }
    }
    int64_t off = 0;
    for (auto& e : entries) {
      timeline_.ActivityStart(e.name, "MEMCPY_IN_FUSION_BUFFER");
      int64_t n = NumElements(e.dims);
      float* seg = fb + off;
      if (half)
        HalfBufToFloat(e.in, seg, n, dtype);
      else
        memcpy(seg, e.in, static_cast<size_t>(n) * 4);
      if (ef) {
        auto it = residuals_.find(e.name);
        if (it == residuals_.end())
          it = residuals_.emplace(e.name, std::vector<float>()).first;
        std::vector<float>& r = it->second;
        if (static_cast<int64_t>(r.size()) != n) {
          residual_bytes_.fetch_add(
              (n - static_cast<int64_t>(r.size())) * 4);
          r.assign(static_cast<size_t>(n), 0.0f);
        }
        // Quantize the local contribution NOW: the residual is measured
        // against exactly what the wire will deliver, and the first
        // reduce-scatter hop then sends these values losslessly.
        for (int64_t i = 0; i < n; ++i) {
          float v = seg[i] + r[i];
          float q = QuantDequant(v, wire);
          r[i] = v - q;
          seg[i] = q;
        }
      }
      off += n;
      timeline_.ActivityEnd(e.name);
    }
    if (ef) residual_tensors_.store(
        static_cast<int64_t>(residuals_.size()));
    if (comp != COMP_NONE && timeline_.Enabled())
      for (auto& e : entries)
        timeline_.Instant(
            e.name, std::string("COMPRESS_") + CompressionName(comp));
    timeline_.ActivityStart(entries[0].name, reduce_activity);
    if (hier) {
      // Two-level: the local hop stays full/native width (halves ship
      // their own width, f32 ships f32) while the cross (DCN) hop takes
      // the negotiated compressed format.
      uint8_t local_wire = half ? wire : 255;
      ok = TwoLevelAllreduce(fb, total_elems, HVD_FLOAT32, local_wire,
                             wire, use_tree, entries[0].name, &err);
    } else {
      ok = RingAllreduceWire(fb, total_elems, wire, opts_.size, opts_.rank,
                             left_ch_, right_ch_, &err);
    }
    timeline_.ActivityEnd(entries[0].name);
    if (ok) {
      off = 0;
      for (auto& e : entries) {
        timeline_.ActivityStart(e.name, "MEMCPY_OUT_FUSION_BUFFER");
        int64_t n = NumElements(e.dims);
        float* seg = fb + off;
        // `average` is a per-tensor attribute, so divide per segment:
        // fused neighbours may mix averaged and summed reductions.
        if (e.average) DivideBuffer(seg, n, HVD_FLOAT32, opts_.size);
        if (half)
          FloatBufToHalf(seg, e.out, n, dtype);
        else
          memcpy(e.out, seg, static_cast<size_t>(n) * 4);
        off += n;
        timeline_.ActivityEnd(e.name);
      }
    }
  } else if (entries.size() == 1 && !half) {
    // Single unfused tensor: skip the fusion buffer, reduce in place on the
    // output (the reference's single-entry in-place path,
    // operations.cc:1186).
    TableEntry& e = entries[0];
    if (e.out != e.in)
      memcpy(e.out, e.in, static_cast<size_t>(total_elems) * esize);
    timeline_.ActivityStart(e.name, reduce_activity);
    ok = do_allreduce(e.out, total_elems, &err);
    timeline_.ActivityEnd(e.name);
    if (ok && e.average) DivideBuffer(e.out, total_elems, dtype, opts_.size);
  } else {
    // Fuse into one contiguous buffer, one pass, scatter back out -- the
    // reference's fusion-buffer dance (operations.cc:1109-1186).  Halves
    // never reach here any more (they always take the f32-master wire
    // path above, at native width on every hop); this branch serves
    // int/f64 payloads at their own width — on the two-level topology as
    // an uncompressed native-dtype two-level pass.
    last_fusion_use_ = std::chrono::steady_clock::now();
    if (fusion_buffer_.size() < static_cast<size_t>(total_elems) * esize)
      fusion_buffer_.resize(static_cast<size_t>(total_elems) * esize);
    char* fb = fusion_buffer_.data();
    int64_t off = 0;
    for (auto& e : entries) {
      timeline_.ActivityStart(e.name, "MEMCPY_IN_FUSION_BUFFER");
      int64_t n = NumElements(e.dims);
      memcpy(fb + off * esize, e.in, static_cast<size_t>(n) * esize);
      off += n;
      timeline_.ActivityEnd(e.name);
    }
    timeline_.ActivityStart(entries[0].name, reduce_activity);
    ok = do_allreduce(fb, total_elems, &err);
    timeline_.ActivityEnd(entries[0].name);
    if (ok) {
      off = 0;
      for (auto& e : entries) {
        timeline_.ActivityStart(e.name, "MEMCPY_OUT_FUSION_BUFFER");
        int64_t n = NumElements(e.dims);
        // `average` is a per-tensor attribute, so divide per segment: fused
        // neighbours may mix averaged and summed reductions.
        memcpy(e.out, fb + off * esize, static_cast<size_t>(n) * esize);
        if (e.average) DivideBuffer(e.out, n, dtype, opts_.size);
        off += n;
        timeline_.ActivityEnd(e.name);
      }
    }
  }
  for (auto& e : entries) {
    timeline_.End(e.name, NumElements(e.dims) * static_cast<int64_t>(esize));
    if (ok) {
      CompleteEntry(e, ST_OK, "");
    } else {
      data_plane_failed_.store(true);
      CompleteEntry(e, ST_UNKNOWN, "ring allreduce failed: " + err);
    }
  }
}

void Engine::ExecuteAllgather(const Response& resp, TableEntry& e) {
  timeline_.Start(e.name, "ALLGATHER");
  size_t esize = DataTypeSize(e.dtype);
  int64_t row_elems = 1;
  for (size_t d = 1; d < e.dims.size(); ++d) row_elems *= e.dims[d];
  int64_t row_bytes = row_elems * static_cast<int64_t>(esize);

  std::vector<int64_t> block_bytes(opts_.size);
  int64_t total_dim0 = 0;
  for (int r = 0; r < opts_.size; ++r) {
    block_bytes[r] = resp.rank_dim0[r] * row_bytes;
    total_dim0 += resp.rank_dim0[r];
  }
  int64_t total_bytes = total_dim0 * row_bytes;

  std::shared_ptr<HandleStatus> status;
  {
    std::lock_guard<std::mutex> lk(handles_mu_);
    auto it = handles_.find(e.handle);
    if (it != handles_.end()) status = it->second;
  }
  if (!status) return;
  status->gathered.resize(static_cast<size_t>(total_bytes));
  status->out_dim0 = total_dim0;
  char* buf = status->gathered.data();
  int64_t my_off = 0;
  for (int r = 0; r < opts_.rank; ++r) my_off += block_bytes[r];
  timeline_.ActivityStart(e.name, "MEMCPY_IN_FUSION_BUFFER");
  memcpy(buf + my_off, e.in, static_cast<size_t>(block_bytes[opts_.rank]));
  timeline_.ActivityEnd(e.name);

  std::string err;
  timeline_.ActivityStart(e.name, "RING_ALLGATHER");
  bool ok = RingAllgather(buf, block_bytes, &err);
  timeline_.ActivityEnd(e.name);
  if (ok && e.out != nullptr)
    memcpy(e.out, buf, static_cast<size_t>(total_bytes));
  timeline_.End(e.name, total_bytes);
  if (ok) {
    CompleteEntry(e, ST_OK, "");
  } else {
    data_plane_failed_.store(true);
    CompleteEntry(e, ST_UNKNOWN, "ring allgather failed: " + err);
  }
}

void Engine::ExecuteBroadcast(const Response& resp, TableEntry& e) {
  timeline_.Start(e.name, "BROADCAST");
  int64_t nbytes = NumElements(e.dims) * static_cast<int64_t>(DataTypeSize(e.dtype));
  if (opts_.rank == e.root_rank && e.out != e.in && e.out != nullptr)
    memcpy(e.out, e.in, static_cast<size_t>(nbytes));
  void* buf = e.out != nullptr ? e.out : const_cast<void*>(e.in);
  std::string err;
  timeline_.ActivityStart(e.name, "RING_BROADCAST");
  bool ok = RingBroadcast(buf, nbytes, e.root_rank, &err);
  timeline_.ActivityEnd(e.name);
  timeline_.End(e.name, nbytes);
  if (ok) {
    CompleteEntry(e, ST_OK, "");
  } else {
    data_plane_failed_.store(true);
    CompleteEntry(e, ST_UNKNOWN, "ring broadcast failed: " + err);
  }
}

// ---------------------------------------------------------------------------
// Point-to-point plane (docs/pipeline.md): negotiated pairwise transfers
// for pipeline parallelism, executed over the same Channel seam the
// collectives ride.
// ---------------------------------------------------------------------------

const Channel* Engine::GetP2pChannel(int peer, std::string* err) {
  const int rank = opts_.rank;
  const int size = opts_.size;
  // Fabric reuse first: when the negotiated pair already sits on a
  // topology channel the transfer rides it — the node-local ring is
  // shm-capable, which is the whole point for intra-host activation
  // traffic.  Safe because both ends execute the same broadcast
  // response at the same list position, so the channel is quiet, and
  // both sides pick the matching direction by the SAME symmetric rule
  // (2-cycles, where the peer is both neighbours, tie-break by the
  // lower id owning the rightward pair).
  const bool hier = opts_.hierarchical_allreduce && opts_.local_size > 1;
  if (hier) {
    const int L = opts_.local_size;
    const int node_base = opts_.rank - opts_.local_rank;
    if (peer >= node_base && peer < node_base + L) {
      int plr = peer - node_base;
      int lr = opts_.local_rank;
      bool at_right = plr == (lr + 1) % L;
      bool at_left = plr == (lr + L - 1) % L;
      if (at_right && at_left)
        return rank < peer ? &local_right_ch_ : &local_left_ch_;
      if (at_right) return &local_right_ch_;
      if (at_left) return &local_left_ch_;
    } else if (n_nodes_ > 1 && peer % L == opts_.local_rank) {
      // Same shard on another node: the sharded cross ring when the
      // node is adjacent.
      int pnode = peer / L;
      bool at_right = pnode == (node_id_ + 1) % n_nodes_;
      bool at_left = pnode == (node_id_ + n_nodes_ - 1) % n_nodes_;
      if (at_right && at_left)
        return node_id_ < pnode ? &cross_right_ch_ : &cross_left_ch_;
      if (at_right) return &cross_right_ch_;
      if (at_left) return &cross_left_ch_;
    }
  }
  {
    bool at_right = peer == (rank + 1) % size;
    bool at_left = peer == (rank + size - 1) % size;
    if (at_right && at_left) return rank < peer ? &right_ch_ : &left_ch_;
    if (at_right) return &right_ch_;
    if (at_left) return &left_ch_;
  }

  // Non-neighbour pair: a dedicated TCP connection, dialed lazily at
  // first use and cached for the job's lifetime (pipeline schedules
  // reuse the same stage pairs every micro-batch).  The LOWER rank
  // dials the higher rank's data listener with a typed hello; the
  // higher rank accepts.  Deterministic rendezvous: both ends reach
  // this call executing the same response at the same list position.
  auto it = p2p_chans_.find(peer);
  if (it != p2p_chans_.end()) return &it->second;
  const uint32_t kHelloP2P = 7u << 24;
  const double kDialTimeout = 120.0;
  if (rank < peer) {
    std::string host;
    int port;
    if (peer >= static_cast<int>(opts_.data_endpoints.size()) ||
        !ParseEndpoint(opts_.data_endpoints[peer], &host, &port)) {
      *err = "bad data endpoint for p2p peer " + std::to_string(peer);
      return nullptr;
    }
    int fd = ConnectRetry(host, port, kDialTimeout, err);
    if (fd < 0) {
      *err = "p2p dial to rank " + std::to_string(peer) + " failed: " + *err;
      return nullptr;
    }
    uint32_t hello = kHelloP2P | static_cast<uint32_t>(rank);
    if (!SendAll(fd, &hello, 4)) {
      *err = "p2p hello send to rank " + std::to_string(peer) + " failed";
      CloseFd(fd);
      return nullptr;
    }
    NetFaultRegister(fd, peer);
    const Channel& ch =
        p2p_chans_.emplace(peer, Channel{fd, nullptr, nullptr, peer})
            .first->second;
    p2p_channels_.store(static_cast<int64_t>(p2p_chans_.size()));
    return &ch;
  }
  // Accept side.  A dial for a LATER response in this rank's list can
  // land in the listen backlog first (the dialer's connect+hello does
  // not wait for the accept), so unexpected p2p hellos from lower ranks
  // are parked in the channel map — they are connections this rank will
  // execute against at their own list position anyway.  Anything else
  // (a stale or foreign hello) is dropped and the wait continues.
  auto deadline = std::chrono::steady_clock::now() +
                  std::chrono::duration<double>(kDialTimeout);
  while (true) {
    double left = std::chrono::duration<double>(
                      deadline - std::chrono::steady_clock::now())
                      .count();
    if (left <= 0.0) {
      *err = "timed out accepting the p2p dial from rank " +
             std::to_string(peer);
      return nullptr;
    }
    int fd = AcceptOne(data_listen_fd_, left, err);
    if (fd < 0) {
      *err = "p2p accept from rank " + std::to_string(peer) +
             " failed: " + *err;
      return nullptr;
    }
    uint32_t hello = 0;
    if (!RecvAll(fd, &hello, 4)) {
      CloseFd(fd);
      continue;
    }
    int from = static_cast<int>(hello & 0x00ffffffu);
    if ((hello & 0xff000000u) != kHelloP2P || from < 0 || from >= rank ||
        p2p_chans_.count(from)) {
      CloseFd(fd);
      continue;
    }
    NetFaultRegister(fd, from);
    p2p_chans_.emplace(from, Channel{fd, nullptr, nullptr, from});
    p2p_channels_.store(static_cast<int64_t>(p2p_chans_.size()));
    if (from == peer) return &p2p_chans_.find(peer)->second;
  }
}

void Engine::CloseP2pChannels() {
  for (auto& kv : p2p_chans_) CloseFd(kv.second.fd);
  p2p_chans_.clear();
  p2p_channels_.store(0);
}

void Engine::ExecuteSendRecv(const Response& resp, TableEntry& e) {
  const bool sender = opts_.rank == resp.p2p_src;
  const int peer = sender ? resp.p2p_dst : resp.p2p_src;
  timeline_.Start(e.name, sender ? "SEND" : "RECV");
  int64_t n = NumElements(e.dims);
  size_t esize = DataTypeSize(e.dtype);
  int64_t nbytes = n * static_cast<int64_t>(esize);

  // The coordinator's negotiated per-transfer compression verdict
  // (fp32 cross-node pairs only; see CoordinatorTick).  Same wire
  // formats and error-feedback residual discipline as the allreduce
  // path, so a compressed activation stream never compounds rounding
  // into drift across micro-batches.
  uint8_t comp = e.dtype == HVD_FLOAT32 ? resp.compression : COMP_NONE;
  uint8_t wire = 255;
  if (comp == COMP_BF16)
    wire = WIRE_BF16;
  else if (comp == COMP_FP8)
    wire = WIRE_FP8;
  int64_t wire_bytes =
      wire == 255 ? nbytes : n * static_cast<int64_t>(WireFormatSize(wire));
  RecordCompressedOp(e.name, comp, nbytes, wire_bytes);

  std::string err;
  const Channel* ch = GetP2pChannel(peer, &err);
  bool ok = ch != nullptr;
  if (ok) {
    timeline_.ActivityStart(e.name, sender ? "P2P_SEND" : "P2P_RECV");
    if (wire == 255) {
      ok = sender
               ? ChannelSendAll(*ch, e.in, static_cast<size_t>(nbytes))
               : ChannelRecvAll(*ch, e.out, static_cast<size_t>(nbytes));
      if (!ok) err = "peer rank " + std::to_string(peer) + " closed";
    } else if (sender) {
      // Residual-map bound: same discipline as ExecuteAllreduce — a
      // never-repeating name stream must not grow the map forever.
      if (!residuals_.count(e.name) && residuals_.size() >= 4096) {
        residuals_.clear();
        residual_bytes_.store(0);
      }
      auto rit = residuals_.emplace(e.name, std::vector<float>()).first;
      std::vector<float>& r = rit->second;
      if (static_cast<int64_t>(r.size()) != n) {
        residual_bytes_.fetch_add((n - static_cast<int64_t>(r.size())) * 4);
        r.assign(static_cast<size_t>(n), 0.0f);
      }
      residual_tensors_.store(static_cast<int64_t>(residuals_.size()));
      const float* src = static_cast<const float*>(e.in);
      std::vector<float> q(static_cast<size_t>(n));
      for (int64_t i = 0; i < n; ++i) {
        float v = src[i] + r[i];
        float w = QuantDequant(v, wire);
        r[i] = v - w;
        q[i] = w;
      }
      std::vector<char> wbuf(static_cast<size_t>(wire_bytes));
      CompressBuf(q.data(), wbuf.data(), n, wire);
      if (timeline_.Enabled())
        timeline_.Instant(e.name,
                          std::string("COMPRESS_") + CompressionName(comp));
      ok = ChannelSendAll(*ch, wbuf.data(), wbuf.size());
      if (!ok) err = "peer rank " + std::to_string(peer) + " closed";
    } else {
      std::vector<char> wbuf(static_cast<size_t>(wire_bytes));
      ok = ChannelRecvAll(*ch, wbuf.data(), wbuf.size());
      if (ok)
        DecompressBuf(wbuf.data(), static_cast<float*>(e.out), n, wire);
      else
        err = "peer rank " + std::to_string(peer) + " closed";
    }
    timeline_.ActivityEnd(e.name);
  }
  timeline_.End(e.name, wire_bytes);
  if (ok) {
    if (sender) {
      p2p_sends_.fetch_add(1);
      p2p_bytes_out_.fetch_add(wire_bytes);
    } else {
      p2p_recvs_.fetch_add(1);
      p2p_bytes_in_.fetch_add(wire_bytes);
    }
    p2p_matched_.fetch_add(1);
    // One ring entry per transfer; a negative arg marks the receive so
    // the postmortem distinguishes direction without a second code.
    if (flight_.Enabled())
      flight_.Record(FL_P2P, e.name, sender ? wire_bytes : -wire_bytes);
    CompleteEntry(e, ST_OK, "");
  } else {
    data_plane_failed_.store(true);
    CompleteEntry(e, ST_UNKNOWN,
                  std::string("p2p ") + (sender ? "send" : "recv") +
                      " failed: " + err);
  }
}

void Engine::ExecuteGroupAllreduce(const Response& resp,
                                   std::vector<TableEntry>& entries) {
  // Stage-scoped allreduce (docs/pipeline.md): the DP reduction inside
  // one pipeline stage.  Never fused (FusesInto), so exactly one entry.
  // Leader-reduce: the first member gathers, accumulates in f32-free
  // native width, and redistributes over p2p channels — stage groups
  // are small (the DP width), so the O(members) star costs less than
  // building a ring per group.
  TableEntry& e = entries[0];
  const std::vector<int32_t>& members = resp.stage_ranks;
  const int leader = members[0];
  timeline_.Start(e.name, "GROUP_ALLREDUCE");
  int64_t n = NumElements(e.dims);
  size_t esize = DataTypeSize(e.dtype);
  int64_t nbytes = n * static_cast<int64_t>(esize);

  std::string err;
  bool ok = true;
  timeline_.ActivityStart(e.name, "GROUP_ALLREDUCE");
  if (opts_.rank == leader) {
    if (e.out != e.in && e.out != nullptr)
      memcpy(e.out, e.in, static_cast<size_t>(nbytes));
    std::vector<char> tmp(static_cast<size_t>(nbytes));
    for (int32_t m : members) {
      if (m == leader) continue;
      const Channel* ch = GetP2pChannel(m, &err);
      if (!ch || !ChannelRecvAll(*ch, tmp.data(), tmp.size())) {
        if (err.empty())
          err = "stage member rank " + std::to_string(m) + " closed";
        ok = false;
        break;
      }
      AccumulateSum(e.out, tmp.data(), n, e.dtype);
    }
    if (ok && e.average)
      DivideBuffer(e.out, n, e.dtype, static_cast<int>(members.size()));
    if (ok) {
      for (int32_t m : members) {
        if (m == leader) continue;
        const Channel* ch = GetP2pChannel(m, &err);
        if (!ch || !ChannelSendAll(*ch, e.out, static_cast<size_t>(nbytes))) {
          if (err.empty())
            err = "stage member rank " + std::to_string(m) + " closed";
          ok = false;
          break;
        }
      }
    }
  } else {
    const Channel* ch = GetP2pChannel(leader, &err);
    ok = ch && ChannelSendAll(*ch, e.in, static_cast<size_t>(nbytes)) &&
         ChannelRecvAll(*ch, e.out, static_cast<size_t>(nbytes));
    if (!ok && err.empty())
      err = "stage leader rank " + std::to_string(leader) + " closed";
  }
  timeline_.ActivityEnd(e.name);
  timeline_.End(e.name, nbytes);
  if (ok) {
    p2p_group_ops_.fetch_add(1);
    CompleteEntry(e, ST_OK, "");
  } else {
    data_plane_failed_.store(true);
    CompleteEntry(e, ST_UNKNOWN, "stage-group allreduce failed: " + err);
  }
}

std::string Engine::P2pInfo() {
  // Unmatched gauge: enqueued send/recv entries still waiting for their
  // counterpart to announce — the number the pipeline stall diagnosis
  // starts from.
  int64_t unmatched = 0;
  {
    std::lock_guard<std::mutex> lk(mu_);
    for (const auto& kv : table_)
      if (kv.second.op == OP_SEND || kv.second.op == OP_RECV) ++unmatched;
  }
  return std::to_string(p2p_sends_.load()) + "|" +
         std::to_string(p2p_recvs_.load()) + "|" +
         std::to_string(p2p_bytes_out_.load()) + "|" +
         std::to_string(p2p_bytes_in_.load()) + "|" +
         std::to_string(p2p_matched_.load()) + "|" +
         std::to_string(unmatched) + "|" +
         std::to_string(p2p_group_ops_.load()) + "|" +
         std::to_string(p2p_channels_.load());
}

void Engine::CompleteEntry(const TableEntry& e, int32_t code,
                           const std::string& error) {
  std::shared_ptr<HandleStatus> status;
  {
    std::lock_guard<std::mutex> lk(handles_mu_);
    auto it = handles_.find(e.handle);
    if (it != handles_.end()) status = it->second;
  }
  if (!status) return;
  // Stamp completion order before `code` flips (readers observe the stamps
  // after seeing a non-pending code).  CompleteEntry only runs on the engine
  // thread, in response-execution order, and response lists are broadcast
  // from rank 0 — so the *relative* order of these stamps is identical
  // across ranks for the same ops.  Waking only THIS handle's cv keeps a
  // group of N outstanding collectives at O(N) wakeups total instead of
  // the O(N^2) a global notify_all per completion costs.
  {
    std::lock_guard<std::mutex> lk(status->mu);
    status->completion_seq = completions_.fetch_add(1);
    status->completion_tick = ticks_done_.load();
    status->negotiation_us = e.negotiation_us;
    status->error = error;
    status->code.store(code);
  }
  status->cv.notify_all();
}

// ---------------------------------------------------------------------------
// Ring data plane.
// ---------------------------------------------------------------------------

bool Engine::RingAllreduce(void* buf, int64_t count, uint8_t dtype,
                           std::string* err) {
  return RingAllreduceOn(buf, count, dtype, opts_.size, opts_.rank, left_ch_,
                         right_ch_, err);
}

namespace {

// Segment bookkeeping for one direction of the bidirectional ring.
// `index` is the rank's position in the (possibly relabeled) ring.
struct HalfRing {
  char* data;
  int64_t count = 0;
  size_t esize;
  int N, index;

  int64_t base() const { return count / N; }
  int64_t rem() const { return count % N; }
  int64_t seg_start(int i) const {
    return i * base() + std::min<int64_t>(i, rem());
  }
  int64_t seg_count(int i) const { return base() + (i < rem() ? 1 : 0); }
  int send_seg(int step, bool gather) const {
    int r = gather ? index + 1 : index;
    return ((r - step) % N + N) % N;
  }
  int recv_seg(int step, bool gather) const {
    int r = gather ? index : index - 1;
    return ((r - step) % N + N) % N;
  }
  char* send_ptr(int step, bool gather) const {
    return data + seg_start(send_seg(step, gather)) * esize;
  }
  size_t send_len(int step, bool gather) const {
    return static_cast<size_t>(seg_count(send_seg(step, gather))) * esize;
  }
  char* recv_ptr(int step, bool gather) const {
    return data + seg_start(recv_seg(step, gather)) * esize;
  }
  size_t recv_len(int step, bool gather) const {
    return static_cast<size_t>(seg_count(recv_seg(step, gather))) * esize;
  }
};

}  // namespace

bool Engine::RingAllreduceOn(void* buf, int64_t count, uint8_t dtype, int N,
                             int index, const Channel& left,
                             const Channel& right, std::string* err) {
  // Bidirectional ring: the buffer splits into two halves that travel in
  // opposite directions simultaneously — half A rightward (send on
  // right_fd, receive on left_fd) and half B leftward on the mirrored ring
  // (relabeling rank r as (N - r) % N turns the physical left neighbour
  // into the logical "right" one, so the same segment schedule applies).
  // Each link is full-duplex TCP, so this doubles usable bandwidth over
  // the unidirectional ring (the role NCCL's multi-channel rings play for
  // the reference, operations.cc:1050).
  if (N == 1 || count == 0) return true;
  size_t esize = DataTypeSize(dtype);
  char* data = static_cast<char*>(buf);
  int64_t cB = count / 2, cA = count - cB;
  HalfRing A{data, cA, esize, N, index};
  HalfRing B{data + cA * esize, cB, esize, N, (N - index) % N};
  int64_t max_seg = cA / N + (cA % N ? 1 : 0);
  int64_t max_seg_b = cB / N + (cB % N ? 1 : 0);
  std::vector<char> tmpA(static_cast<size_t>(max_seg) * esize);
  std::vector<char> tmpB(static_cast<size_t>(max_seg_b) * esize);

  // Phase 1: reduce-scatter both halves.  After N-1 steps this rank owns
  // fully reduced segment (index+1) of A and (mirror+1) of B.
  for (int step = 0; step < N - 1; ++step) {
    if (!ChannelExchangeBi(right, A.send_ptr(step, false),
                           A.send_len(step, false), tmpB.data(),
                           B.recv_len(step, false), left,
                           B.send_ptr(step, false), B.send_len(step, false),
                           tmpA.data(), A.recv_len(step, false))) {
      *err = "neighbour exchange failed (reduce-scatter step " +
             std::to_string(step) + ")";
      return false;
    }
    AccumulateSum(A.recv_ptr(step, false), tmpA.data(),
                  A.seg_count(A.recv_seg(step, false)), dtype);
    AccumulateSum(B.recv_ptr(step, false), tmpB.data(),
                  B.seg_count(B.recv_seg(step, false)), dtype);
  }
  // Phase 2: allgather of reduced segments, both directions.
  for (int step = 0; step < N - 1; ++step) {
    if (!ChannelExchangeBi(right, A.send_ptr(step, true),
                           A.send_len(step, true), B.recv_ptr(step, true),
                           B.recv_len(step, true), left,
                           B.send_ptr(step, true), B.send_len(step, true),
                           A.recv_ptr(step, true), A.recv_len(step, true))) {
      *err = "neighbour exchange failed (allgather step " +
             std::to_string(step) + ")";
      return false;
    }
  }
  return true;
}

bool Engine::RingAllreduceWire(float* buf, int64_t count, uint8_t wire,
                               int N, int index, const Channel& left,
                               const Channel& right, std::string* err) {
  // The bidirectional ring of RingAllreduceOn with the wire narrowed:
  // the local buffer stays f32 (every hop accumulates in f32), segments
  // are compressed at the send boundary and decompressed at the receive
  // boundary.  The allgather phase recompresses the owner's reduced f32
  // segment on every forward hop — exact, because dequantized values are
  // representable in the wire format by construction — so forwarding
  // needs no wire-byte staging.
  if (N == 1 || count == 0) return true;
  const size_t wsz = WireFormatSize(wire);
  int64_t cB = count / 2, cA = count - cB;
  HalfRing A{reinterpret_cast<char*>(buf), cA, sizeof(float), N, index};
  HalfRing B{reinterpret_cast<char*>(buf + cA), cB, sizeof(float), N,
             (N - index) % N};
  int64_t max_a = cA / N + (cA % N ? 1 : 0);
  int64_t max_b = cB / N + (cB % N ? 1 : 0);
  std::vector<uint8_t> send_a(static_cast<size_t>(max_a) * wsz);
  std::vector<uint8_t> send_b(static_cast<size_t>(max_b) * wsz);
  std::vector<uint8_t> recv_a(static_cast<size_t>(max_a) * wsz);
  std::vector<uint8_t> recv_b(static_cast<size_t>(max_b) * wsz);
  float* bufB = buf + cA;

  for (int gather = 0; gather < 2; ++gather) {
    bool g = gather != 0;
    for (int step = 0; step < N - 1; ++step) {
      int64_t sa = A.seg_count(A.send_seg(step, g));
      int64_t sb = B.seg_count(B.send_seg(step, g));
      int64_t ra = A.seg_count(A.recv_seg(step, g));
      int64_t rb = B.seg_count(B.recv_seg(step, g));
      CompressBuf(buf + A.seg_start(A.send_seg(step, g)), send_a.data(), sa,
                  wire);
      CompressBuf(bufB + B.seg_start(B.send_seg(step, g)), send_b.data(), sb,
                  wire);
      if (!ChannelExchangeBi(right, send_a.data(),
                             static_cast<size_t>(sa) * wsz, recv_b.data(),
                             static_cast<size_t>(rb) * wsz, left,
                             send_b.data(), static_cast<size_t>(sb) * wsz,
                             recv_a.data(), static_cast<size_t>(ra) * wsz)) {
        *err = std::string("neighbour exchange failed (compressed ") +
               (g ? "allgather" : "reduce-scatter") + " step " +
               std::to_string(step) + ")";
        return false;
      }
      if (g) {
        // Allgather: adopt the fully reduced segment as broadcast.
        DecompressBuf(recv_a.data(), buf + A.seg_start(A.recv_seg(step, g)),
                      ra, wire);
        DecompressBuf(recv_b.data(), bufB + B.seg_start(B.recv_seg(step, g)),
                      rb, wire);
      } else {
        // Reduce-scatter: accumulate in f32.
        DecompressAccumulate(recv_a.data(),
                             buf + A.seg_start(A.recv_seg(step, g)), ra,
                             wire);
        DecompressAccumulate(recv_b.data(),
                             bufB + B.seg_start(B.recv_seg(step, g)), rb,
                             wire);
      }
    }
    // The owned, fully reduced segments are forwarded quantized during
    // the allgather phase; quantize the local copy too, so every rank
    // ends with IDENTICAL values (the owner must not keep a higher-
    // precision copy than it broadcast).
    if (!g) {
      int64_t oa = A.seg_count(A.send_seg(0, true));
      float* pa = buf + A.seg_start(A.send_seg(0, true));
      for (int64_t i = 0; i < oa; ++i) pa[i] = QuantDequant(pa[i], wire);
      int64_t ob = B.seg_count(B.send_seg(0, true));
      float* pb = bufB + B.seg_start(B.send_seg(0, true));
      for (int64_t i = 0; i < ob; ++i) pb[i] = QuantDequant(pb[i], wire);
    }
  }
  return true;
}

uint8_t Engine::ChooseCompression(uint8_t dtype, int64_t bytes) const {
  uint8_t mode = static_cast<uint8_t>(cur_compression_.load());
  if (mode == COMP_NONE) return COMP_NONE;
  // Lossy wire formats apply to fp32 payloads only: f16/bf16 already
  // ship at native width and integer sums must stay exact.  A
  // single-rank job moves no wire bytes at all.  On the two-level
  // topology the verdict narrows the cross-node (DCN) hop while the
  // intra-node hop stays full width (TwoLevelAllreduce).
  if (dtype != HVD_FLOAT32) return COMP_NONE;
  if (opts_.size <= 1) return COMP_NONE;
  // A single-node two-level job has no DCN hop — the only hop the
  // verdict narrows — so compressing would round gradients for zero
  // wire savings (and report a phantom compression win in the metrics).
  if (opts_.hierarchical_allreduce && n_nodes_ <= 1) return COMP_NONE;
  // The min-bytes floor keeps latency-bound small buckets uncompressed:
  // their cost is negotiation + syscalls, not bandwidth, and the
  // quantize/dequantize passes would be pure overhead.
  if (bytes < opts_.compression_min_bytes) return COMP_NONE;
  return mode;
}

void Engine::RecordCompressedOp(const std::string& name, uint8_t mode,
                                int64_t payload_bytes, int64_t wire_bytes) {
  comp_payload_bytes_.fetch_add(payload_bytes);
  comp_wire_bytes_.fetch_add(wire_bytes);
  switch (mode) {
    case COMP_BF16: comp_ops_bf16_.fetch_add(1); break;
    case COMP_FP8: comp_ops_fp8_.fetch_add(1); break;
    default: comp_ops_none_.fetch_add(1); break;
  }
  std::lock_guard<std::mutex> lk(comp_mu_);
  std::string entry;
  for (char c : name) entry += (c == ';' || c == '|') ? '_' : c;
  entry += std::string("|") + CompressionName(mode);
  comp_log_.push_back(std::move(entry));
  while (comp_log_.size() > 256) comp_log_.pop_front();
}

std::string Engine::CompressionInfo() {
  return std::to_string(comp_wire_bytes_.load()) + "|" +
         std::to_string(comp_payload_bytes_.load()) + "|" +
         std::to_string(comp_ops_none_.load()) + "|" +
         std::to_string(comp_ops_bf16_.load()) + "|" +
         std::to_string(comp_ops_fp8_.load()) + "|" +
         std::to_string(residual_bytes_.load()) + "|" +
         std::to_string(residual_tensors_.load()) + "|" +
         std::to_string(cur_comp_min_bytes_.load());
}

std::string Engine::CompressionLog() {
  std::lock_guard<std::mutex> lk(comp_mu_);
  std::string out;
  for (const auto& e : comp_log_) {
    if (!out.empty()) out += ';';
    out += e;
  }
  return out;
}

// Segment bookkeeping for the node-local reduce-scatter/allgather: `n`
// elements split into `P` near-equal parts (the first `rem` get one
// extra), matching the HalfRing partition convention.
namespace {
struct SegPart {
  int64_t n;
  int P;
  int64_t base() const { return n / P; }
  int64_t rem() const { return n % P; }
  int64_t start(int i) const {
    return i * base() + std::min<int64_t>(i, rem());
  }
  int64_t cnt(int i) const { return base() + (i < rem() ? 1 : 0); }
};
}  // namespace

bool Engine::LocalReduceScatter(char* data, int64_t n, uint8_t dtype,
                                uint8_t wire, int64_t* bytes_moved,
                                std::string* err) {
  const int L = opts_.local_size, r = opts_.local_rank;
  if (L == 1 || n == 0) return true;
  const size_t esize = DataTypeSize(dtype);
  const size_t unit = wire == 255 ? esize : WireFormatSize(wire);
  SegPart part{n, L};
  int64_t max_seg = part.base() + (part.rem() ? 1 : 0);
  std::vector<uint8_t> sendw;
  if (wire != 255) sendw.resize(static_cast<size_t>(max_seg) * unit);
  std::vector<uint8_t> recvw(static_cast<size_t>(max_seg) *
                             std::max(unit, esize));
  // Standard ring reduce-scatter: after L-1 steps local rank r owns the
  // fully reduced segment (r+1) % L.
  for (int step = 0; step < L - 1; ++step) {
    int ss = ((r - step) % L + L) % L;
    int rs = ((r - step - 1) % L + L) % L;
    const void* sp = data + part.start(ss) * esize;
    if (wire != 255) {
      CompressBuf(reinterpret_cast<const float*>(data) + part.start(ss),
                  sendw.data(), part.cnt(ss), wire);
      sp = sendw.data();
    }
    if (!ChannelExchange(local_right_ch_, sp,
                         static_cast<size_t>(part.cnt(ss)) * unit,
                         local_left_ch_, recvw.data(),
                         static_cast<size_t>(part.cnt(rs)) * unit)) {
      *err = "node-local reduce-scatter exchange failed (step " +
             std::to_string(step) + ")";
      return false;
    }
    *bytes_moved += part.cnt(ss) * static_cast<int64_t>(unit);
    if (wire == 255)
      AccumulateSum(data + part.start(rs) * esize, recvw.data(),
                    part.cnt(rs), dtype);
    else
      DecompressAccumulate(recvw.data(),
                           reinterpret_cast<float*>(data) + part.start(rs),
                           part.cnt(rs), wire);
  }
  return true;
}

bool Engine::LocalAllgather(char* data, int64_t n, uint8_t dtype,
                            uint8_t wire, int64_t* bytes_moved,
                            std::string* err) {
  const int L = opts_.local_size, r = opts_.local_rank;
  if (L == 1 || n == 0) return true;
  const size_t esize = DataTypeSize(dtype);
  const size_t unit = wire == 255 ? esize : WireFormatSize(wire);
  SegPart part{n, L};
  int64_t max_seg = part.base() + (part.rem() ? 1 : 0);
  std::vector<uint8_t> sendw, recvw;
  if (wire != 255) {
    sendw.resize(static_cast<size_t>(max_seg) * unit);
    recvw.resize(static_cast<size_t>(max_seg) * unit);
  }
  // Ring allgather from the RS ownership map (rank r owns (r+1) % L):
  // step s forwards segment (r+1-s) % L rightward and adopts
  // (r-s) % L from the left.
  for (int step = 0; step < L - 1; ++step) {
    int ss = ((r + 1 - step) % L + L) % L;
    int rs = ((r - step) % L + L) % L;
    const void* sp = data + part.start(ss) * esize;
    void* rp = data + part.start(rs) * esize;
    if (wire != 255) {
      // Exact: allgather segments are already wire-representable (the
      // owner quantized its reduced segment before the first forward).
      CompressBuf(reinterpret_cast<const float*>(data) + part.start(ss),
                  sendw.data(), part.cnt(ss), wire);
      sp = sendw.data();
      rp = recvw.data();
    }
    if (!ChannelExchange(local_right_ch_, sp,
                         static_cast<size_t>(part.cnt(ss)) * unit,
                         local_left_ch_, rp,
                         static_cast<size_t>(part.cnt(rs)) * unit)) {
      *err = "node-local allgather exchange failed (step " +
             std::to_string(step) + ")";
      return false;
    }
    *bytes_moved += part.cnt(ss) * static_cast<int64_t>(unit);
    if (wire != 255)
      DecompressBuf(recvw.data(),
                    reinterpret_cast<float*>(data) + part.start(rs),
                    part.cnt(rs), wire);
  }
  return true;
}

bool Engine::CrossTreeAllreduce(char* seg, int64_t n, uint8_t dtype,
                                uint8_t wire, std::string* err) {
  const size_t esize = DataTypeSize(dtype);
  const size_t unit = wire == 255 ? esize : WireFormatSize(wire);
  std::vector<uint8_t> sendw;
  if (wire != 255) sendw.resize(static_cast<size_t>(n) * unit);
  std::vector<uint8_t> recvw(static_cast<size_t>(n) * unit);
  float* f = reinterpret_cast<float*>(seg);
  // Recursive doubling: at level k, XOR partners exchange their full
  // running sums and both add — log2(nodes) latency steps, the win for
  // latency-bound small shards.
  for (size_t k = 0; k < cross_tree_fds_.size(); ++k) {
    int fd = cross_tree_fds_[k];
    if (fd < 0) {
      *err = "cross-node tree partner closed after an earlier failure";
      return false;
    }
    const void* sp = seg;
    if (wire != 255) {
      // Quantize the running sum first, so both partners add IDENTICAL
      // dequantized values — float addition is commutative, which keeps
      // every node's shard bit-identical through the whole tree.
      for (int64_t i = 0; i < n; ++i) f[i] = QuantDequant(f[i], wire);
      CompressBuf(f, sendw.data(), n, wire);
      sp = sendw.data();
    }
    // Ad-hoc channel: tree partners are TCP-only (they live on other
    // hosts by construction), but routing through the seam keeps the
    // telemetry and chaos hooks uniform.
    Channel tc{fd, nullptr, nullptr,
               (node_id_ ^ (1 << k)) * opts_.local_size + opts_.local_rank};
    if (!ChannelExchange(tc, sp, static_cast<size_t>(n) * unit, tc,
                         recvw.data(), static_cast<size_t>(n) * unit)) {
      *err = "cross-node tree exchange failed (level " +
             std::to_string(k) + ")";
      return false;
    }
    if (wire == 255)
      AccumulateSum(seg, recvw.data(), n, dtype);
    else
      DecompressAccumulate(recvw.data(), f, n, wire);
  }
  return true;
}

bool Engine::CrossShardAllreduce(char* seg, int64_t n, uint8_t dtype,
                                 uint8_t wire, bool use_tree,
                                 int64_t* bytes_moved, std::string* err) {
  if (n_nodes_ == 1 || n == 0) return true;
  const size_t esize = DataTypeSize(dtype);
  const size_t unit = wire == 255 ? esize : WireFormatSize(wire);
  if (use_tree && !cross_tree_fds_.empty()) {
    if (!CrossTreeAllreduce(seg, n, dtype, wire, err)) return false;
    *bytes_moved += static_cast<int64_t>(cross_tree_fds_.size()) * n *
                    static_cast<int64_t>(unit);
    return true;
  }
  if (cross_left_fd_ < 0 || cross_right_fd_ < 0) {
    *err = "cross-node ring closed after an earlier failure";
    return false;
  }
  bool ok =
      wire == 255
          ? RingAllreduceOn(seg, n, dtype, n_nodes_, node_id_,
                            cross_left_ch_, cross_right_ch_, err)
          : RingAllreduceWire(reinterpret_cast<float*>(seg), n, wire,
                              n_nodes_, node_id_, cross_left_ch_,
                              cross_right_ch_, err);
  if (ok)
    *bytes_moved += 2 * static_cast<int64_t>(n_nodes_ - 1) *
                    ((n + n_nodes_ - 1) / n_nodes_) *
                    static_cast<int64_t>(unit);
  return ok;
}

bool Engine::TwoLevelAllreduce(void* vbuf, int64_t count, uint8_t dtype,
                               uint8_t local_wire, uint8_t cross_wire,
                               bool use_tree, const std::string& name,
                               std::string* err) {
  // The bandwidth-optimal two-level decomposition (docs/performance.md
  // #two-level-topology), replacing the reference's ncclReduce ->
  // MPI_Allreduce -> ncclBcast star (operations.cc:1003-1048):
  //
  //   1. LOCAL_RS    node-local ring reduce-scatter — local rank r ends
  //                  owning the fully node-reduced shard (r+1) % L.
  //   2. CROSS_*     EVERY local rank drives its own cross-node
  //                  exchange (ring or recursive-doubling tree) over its
  //                  shard — local_size parallel DCN streams instead of
  //                  one leader NIC, optionally compressed (bf16/fp8
  //                  with f32 accumulation, the wire-compression machinery).
  //   3. LOCAL_AG    node-local ring allgather of the reduced shards.
  //
  // Chunk-level pipelining: the bucket splits into chunks; a helper
  // thread runs phase 2 on the cross fds while the engine thread runs
  // phases 1/3 on the local fds, so the local hops of chunk c overlap
  // the DCN hop of its neighbours instead of waiting behind phase
  // barriers.  Sum semantics throughout; averaging stays the caller's
  // divide-by-global-size.
  if (opts_.size == 1 || count == 0) return true;
  const int L = opts_.local_size;
  const int M = n_nodes_;
  char* data = static_cast<char*>(vbuf);
  const size_t esize = DataTypeSize(dtype);
  if (L > 1 && (local_left_fd_ < 0 || local_right_fd_ < 0)) {
    *err = "node-local ring closed after an earlier failure";
    return false;
  }
  if (M > 1 && (cross_left_fd_ < 0 || cross_right_fd_ < 0)) {
    *err = "cross-node ring closed after an earlier failure";
    return false;
  }
  const int64_t kChunkBytes = 4 << 20;
  int64_t chunk_elems =
      std::max<int64_t>(kChunkBytes / static_cast<int64_t>(esize), L);
  int n_chunks = static_cast<int>((count + chunk_elems - 1) / chunk_elems);

  int64_t local_bytes = 0, cross_bytes = 0;
  int64_t local_rs_us = 0, cross_us_total = 0, local_ag_us = 0;

  // Pipeline handshake: rs_done / cross_done are chunk high-water marks.
  std::mutex pmu;
  std::condition_variable pcv;
  int rs_done = 0, cross_done = 0;
  bool failed = false;
  std::string cross_err;

  const int own = (opts_.local_rank + 1) % L;
  auto own_seg = [&](int c, int64_t* s, int64_t* cn) {
    int64_t off = static_cast<int64_t>(c) * chunk_elems;
    int64_t n = std::min(chunk_elems, count - off);
    SegPart part{n, L};
    *s = off + part.start(own);
    *cn = part.cnt(own);
  };

  // Pipelining pays one thread spawn per bucket; a single-chunk bucket
  // has nothing to overlap, so latency-bound buckets run the cross hop
  // inline on the engine thread instead.
  const bool pipelined = M > 1 && n_chunks > 1;
  std::thread cross_thread;
  if (pipelined) {
    cross_thread = std::thread([&]() {
      for (int c = 0; c < n_chunks; ++c) {
        {
          std::unique_lock<std::mutex> lk(pmu);
          pcv.wait(lk, [&] { return rs_done > c || failed; });
          if (failed) return;
        }
        int64_t s, cn;
        own_seg(c, &s, &cn);
        std::string e;
        auto t0 = std::chrono::steady_clock::now();
        bool ok_c = CrossShardAllreduce(data + s * esize, cn, dtype,
                                        cross_wire, use_tree, &cross_bytes,
                                        &e);
        cross_us_total +=
            std::chrono::duration_cast<std::chrono::microseconds>(
                std::chrono::steady_clock::now() - t0)
                .count();
        std::lock_guard<std::mutex> lk(pmu);
        if (!ok_c) {
          failed = true;
          cross_err = e;
          pcv.notify_all();
          return;
        }
        cross_done = c + 1;
        pcv.notify_all();
      }
    });
  }

  bool ok = true;
  // Phase 1: each reduce-scattered chunk is handed to the cross thread
  // immediately.
  timeline_.ActivityStart(name, "LOCAL_RS");
  {
    auto t0 = std::chrono::steady_clock::now();
    for (int c = 0; c < n_chunks && ok; ++c) {
      int64_t off = static_cast<int64_t>(c) * chunk_elems;
      int64_t n = std::min(chunk_elems, count - off);
      if (!LocalReduceScatter(data + off * esize, n, dtype, local_wire,
                              &local_bytes, err)) {
        ok = false;
        break;
      }
      std::lock_guard<std::mutex> lk(pmu);
      rs_done = c + 1;
      pcv.notify_all();
    }
    local_rs_us = std::chrono::duration_cast<std::chrono::microseconds>(
                      std::chrono::steady_clock::now() - t0)
                      .count();
  }
  timeline_.ActivityEnd(name);
  // Phase 2 as the engine thread sees it: pipelined, the exposed head of
  // the cross pipeline (the DCN hop of later chunks overlaps phase 3
  // below); unpipelined, the whole inline cross exchange.
  if (ok && M > 1) {
    timeline_.ActivityStart(name, use_tree && !cross_tree_fds_.empty()
                                      ? "CROSS_TREE"
                                      : "CROSS_RING");
    if (pipelined) {
      std::unique_lock<std::mutex> lk(pmu);
      pcv.wait(lk, [&] { return cross_done >= 1 || failed; });
    } else {
      for (int c = 0; c < n_chunks && ok; ++c) {
        int64_t s, cn;
        own_seg(c, &s, &cn);
        auto t0 = std::chrono::steady_clock::now();
        if (!CrossShardAllreduce(data + s * esize, cn, dtype, cross_wire,
                                 use_tree, &cross_bytes, err))
          ok = false;
        cross_us_total +=
            std::chrono::duration_cast<std::chrono::microseconds>(
                std::chrono::steady_clock::now() - t0)
                .count();
      }
    }
    timeline_.ActivityEnd(name);
  }
  // Phase 3: allgather each chunk as its cross hop completes.
  if (ok) {
    timeline_.ActivityStart(name, "LOCAL_AG");
    for (int c = 0; c < n_chunks && ok; ++c) {
      if (pipelined) {
        std::unique_lock<std::mutex> lk(pmu);
        pcv.wait(lk, [&] { return cross_done > c || failed; });
        if (failed) {
          ok = false;
          break;
        }
      }
      int64_t off = static_cast<int64_t>(c) * chunk_elems;
      int64_t n = std::min(chunk_elems, count - off);
      if (local_wire != 255) {
        // The reduced shard is forwarded narrowed: quantize the local
        // copy first so every local rank converges to IDENTICAL values
        // (the RingAllreduceWire owner-quantize rule).  Exact when the
        // cross hop already quantized to the same format.
        int64_t s, cn;
        own_seg(c, &s, &cn);
        float* p = reinterpret_cast<float*>(data) + s;
        for (int64_t i = 0; i < cn; ++i)
          p[i] = QuantDequant(p[i], local_wire);
      }
      auto t0 = std::chrono::steady_clock::now();
      if (!LocalAllgather(data + off * esize, n, dtype, local_wire,
                          &local_bytes, err))
        ok = false;
      local_ag_us += std::chrono::duration_cast<std::chrono::microseconds>(
                         std::chrono::steady_clock::now() - t0)
                         .count();
    }
    timeline_.ActivityEnd(name);
  }
  {
    std::lock_guard<std::mutex> lk(pmu);
    if (!ok) failed = true;
    pcv.notify_all();
  }
  // On any failure wake everyone fast: peers blocked on our topology
  // sockets see EOF instead of stalling to the 30s exchange timeout, and
  // the helper thread's in-flight exchange errors out so the join below
  // cannot hang.  Close (and latch the fds at -1) only after the join.
  if (!ok) ShutdownTopologyFds();
  if (cross_thread.joinable()) cross_thread.join();
  if (ok && failed) {
    ok = false;
    ShutdownTopologyFds();
  }
  if (!ok && err->empty())
    *err = cross_err.empty() ? "cross-node exchange failed" : cross_err;
  if (!ok) CloseTopologyFds();
  topo_local_bytes_.fetch_add(local_bytes);
  topo_cross_bytes_.fetch_add(cross_bytes);
  RecordTopologyOp(name, use_tree && M > 1 && !cross_tree_fds_.empty(),
                   local_rs_us, cross_us_total, local_ag_us);
  return ok;
}

void Engine::RecordTopologyOp(const std::string& name, bool tree,
                              int64_t local_rs_us, int64_t cross_us,
                              int64_t local_ag_us) {
  std::lock_guard<std::mutex> lk(topo_mu_);
  std::string entry;
  for (char c : name) entry += (c == ';' || c == '|') ? '_' : c;
  entry += std::string("|") + (tree ? "tree" : "ring") + "|" +
           std::to_string(local_rs_us) + "|" + std::to_string(cross_us) +
           "|" + std::to_string(local_ag_us);
  topo_log_.push_back(std::move(entry));
  while (topo_log_.size() > 256) topo_log_.pop_front();
  ++topo_log_total_;
  // Cumulative phase sums: the anomaly detector's per-phase input (sweep
  // deltas -> mean phase time per interval, no log parsing).
  topo_rs_us_.fetch_add(local_rs_us);
  topo_cross_us_.fetch_add(cross_us);
  topo_ag_us_.fetch_add(local_ag_us);
  topo_timed_ops_.fetch_add(1);
}

std::string Engine::TopologyInfo() {
  int64_t log_total;
  {
    std::lock_guard<std::mutex> lk(topo_mu_);
    log_total = topo_log_total_;
  }
  bool hier = topo_hier_.load() && cur_size_.load() > 1;
  return std::string(hier ? "1" : "0") + "|" +
         std::to_string(topo_nodes_.load()) +
         "|" + std::to_string(cur_local_size_.load()) + "|" +
         std::to_string(cur_cross_algo_.load()) + "|" +
         std::to_string(topo_ops_ring_.load()) + "|" +
         std::to_string(topo_ops_tree_.load()) + "|" +
         std::to_string(topo_local_bytes_.load()) + "|" +
         std::to_string(topo_cross_bytes_.load()) + "|" +
         std::to_string(log_total) + "|" +
         (topo_shm_.load() ? "shm" : "tcp");
}

std::string Engine::TopologyLog() {
  std::lock_guard<std::mutex> lk(topo_mu_);
  std::string out;
  for (const auto& e : topo_log_) {
    if (!out.empty()) out += ';';
    out += e;
  }
  return out;
}

bool Engine::RingAllgather(char* buf, const std::vector<int64_t>& block_bytes,
                           std::string* err) {
  int N = opts_.size;
  if (N == 1) return true;
  std::vector<int64_t> off(N, 0);
  for (int i = 1; i < N; ++i) off[i] = off[i - 1] + block_bytes[i - 1];
  int r = opts_.rank;
  for (int step = 0; step < N - 1; ++step) {
    int ss = ((r - step) % N + N) % N;
    int rs = ((r - step - 1) % N + N) % N;
    if (!ChannelExchange(right_ch_, buf + off[ss],
                         static_cast<size_t>(block_bytes[ss]), left_ch_,
                         buf + off[rs], static_cast<size_t>(block_bytes[rs]))) {
      *err = "neighbour exchange failed (allgather step " +
             std::to_string(step) + ")";
      return false;
    }
  }
  return true;
}

bool Engine::RingBroadcast(void* buf, int64_t nbytes, int root,
                           std::string* err) {
  int N = opts_.size;
  if (N == 1 || nbytes == 0) return true;
  const int64_t kChunk = 1 << 20;  // pipeline at 1 MiB granularity
  int dist = ((opts_.rank - root) % N + N) % N;
  bool recv_from_left = dist != 0;
  bool send_to_right = dist != N - 1;
  char* p = static_cast<char*>(buf);
  for (int64_t o = 0; o < nbytes; o += kChunk) {
    int64_t len = std::min(kChunk, nbytes - o);
    if (recv_from_left &&
        !ChannelRecvAll(left_ch_, p + o, static_cast<size_t>(len))) {
      *err = "broadcast recv failed";
      return false;
    }
    if (send_to_right &&
        !ChannelSendAll(right_ch_, p + o, static_cast<size_t>(len))) {
      *err = "broadcast send failed";
      return false;
    }
  }
  return true;
}

// ---------------------------------------------------------------------------
// Handle API.
// ---------------------------------------------------------------------------

int Engine::Poll(int64_t handle) {
  std::lock_guard<std::mutex> lk(handles_mu_);
  auto it = handles_.find(handle);
  if (it == handles_.end()) return -1;
  return it->second->code.load() == ST_PENDING ? 0 : 1;
}

int32_t Engine::Wait(int64_t handle) {
  std::shared_ptr<HandleStatus> status;
  {
    std::lock_guard<std::mutex> lk(handles_mu_);
    auto it = handles_.find(handle);
    if (it == handles_.end()) return ST_INVALID;
    status = it->second;
  }
  std::unique_lock<std::mutex> lk(status->mu);
  status->cv.wait(lk, [&]() { return status->code.load() != ST_PENDING; });
  return status->code.load();
}

int32_t Engine::StatusOf(int64_t handle, std::string* error) {
  std::lock_guard<std::mutex> lk(handles_mu_);
  auto it = handles_.find(handle);
  if (it == handles_.end()) return ST_INVALID;
  if (error) *error = it->second->error;
  return it->second->code.load();
}

int64_t Engine::CompletionSeq(int64_t handle) {
  std::lock_guard<std::mutex> lk(handles_mu_);
  auto it = handles_.find(handle);
  if (it == handles_.end() || it->second->code.load() == ST_PENDING) return -1;
  return it->second->completion_seq;
}

int64_t Engine::CompletionTick(int64_t handle) {
  std::lock_guard<std::mutex> lk(handles_mu_);
  auto it = handles_.find(handle);
  if (it == handles_.end() || it->second->code.load() == ST_PENDING) return -1;
  return it->second->completion_tick;
}

int64_t Engine::NegotiationUs(int64_t handle) {
  std::lock_guard<std::mutex> lk(handles_mu_);
  auto it = handles_.find(handle);
  if (it == handles_.end() || it->second->code.load() == ST_PENDING) return -1;
  return it->second->negotiation_us;
}

int64_t Engine::ResultBytes(int64_t handle) {
  std::lock_guard<std::mutex> lk(handles_mu_);
  auto it = handles_.find(handle);
  if (it == handles_.end()) return -1;
  return static_cast<int64_t>(it->second->gathered.size());
}

int64_t Engine::ResultDim0(int64_t handle) {
  std::lock_guard<std::mutex> lk(handles_mu_);
  auto it = handles_.find(handle);
  if (it == handles_.end()) return -1;
  return it->second->out_dim0;
}

bool Engine::CopyResult(int64_t handle, void* dst, int64_t nbytes) {
  std::shared_ptr<HandleStatus> status;
  {
    std::lock_guard<std::mutex> lk(handles_mu_);
    auto it = handles_.find(handle);
    if (it == handles_.end()) return false;
    status = it->second;
  }
  if (nbytes != static_cast<int64_t>(status->gathered.size())) return false;
  memcpy(dst, status->gathered.data(), static_cast<size_t>(nbytes));
  return true;
}

void* Engine::ResultPtr(int64_t handle) {
  std::lock_guard<std::mutex> lk(handles_mu_);
  auto it = handles_.find(handle);
  if (it == handles_.end() || it->second->code.load() == ST_PENDING ||
      it->second->gathered.empty())
    return nullptr;
  return it->second->gathered.data();
}

void Engine::Release(int64_t handle) {
  std::lock_guard<std::mutex> lk(handles_mu_);
  handles_.erase(handle);
}

}  // namespace hvdtpu
