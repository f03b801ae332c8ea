#include "wire.h"

#include <cstring>

namespace hvdtpu {

size_t DataTypeSize(uint8_t dtype) {
  switch (dtype) {
    case HVD_UINT8:
    case HVD_INT8:
    case HVD_BOOL:
      return 1;
    case HVD_FLOAT16:
    case HVD_BFLOAT16:
    case HVD_UINT16:
      return 2;
    case HVD_INT32:
    case HVD_FLOAT32:
      return 4;
    case HVD_INT64:
    case HVD_FLOAT64:
      return 8;
    default:
      return 0;
  }
}

const char* DataTypeName(uint8_t dtype) {
  switch (dtype) {
    case HVD_UINT8: return "uint8";
    case HVD_INT8: return "int8";
    case HVD_INT32: return "int32";
    case HVD_INT64: return "int64";
    case HVD_FLOAT16: return "float16";
    case HVD_FLOAT32: return "float32";
    case HVD_FLOAT64: return "float64";
    case HVD_BFLOAT16: return "bfloat16";
    case HVD_BOOL: return "bool";
    case HVD_UINT16: return "uint16";
    default: return "<unknown dtype>";
  }
}

const char* OpName(uint8_t op) {
  switch (op) {
    case OP_ALLREDUCE: return "allreduce";
    case OP_ALLGATHER: return "allgather";
    case OP_BROADCAST: return "broadcast";
    case OP_NOOP: return "cached-negotiation";
    case OP_SEND: return "send";
    case OP_RECV: return "recv";
    default: return "<unknown op>";
  }
}

const char* CompressionName(uint8_t mode) {
  switch (mode) {
    case COMP_NONE: return "none";
    case COMP_BF16: return "bf16";
    case COMP_FP8: return "fp8";
    default: return "<unknown compression>";
  }
}

namespace {

class Writer {
 public:
  std::vector<uint8_t> buf;
  void U8(uint8_t v) { buf.push_back(v); }
  void I32(int32_t v) {
    for (int i = 0; i < 4; ++i) buf.push_back((static_cast<uint32_t>(v) >> (8 * i)) & 0xff);
  }
  void U32(uint32_t v) {
    for (int i = 0; i < 4; ++i) buf.push_back((v >> (8 * i)) & 0xff);
  }
  void I64(int64_t v) {
    for (int i = 0; i < 8; ++i) buf.push_back((static_cast<uint64_t>(v) >> (8 * i)) & 0xff);
  }
  void Str(const std::string& s) {
    U32(static_cast<uint32_t>(s.size()));
    buf.insert(buf.end(), s.begin(), s.end());
  }
};

class Reader {
 public:
  const uint8_t* p;
  const uint8_t* end;
  bool ok = true;
  Reader(const std::vector<uint8_t>& b) : p(b.data()), end(b.data() + b.size()) {}
  bool Need(size_t n) {
    if (static_cast<size_t>(end - p) < n) { ok = false; return false; }
    return true;
  }
  uint8_t U8() { if (!Need(1)) return 0; return *p++; }
  uint32_t U32() {
    if (!Need(4)) return 0;
    uint32_t v = 0;
    for (int i = 0; i < 4; ++i) v |= static_cast<uint32_t>(*p++) << (8 * i);
    return v;
  }
  int32_t I32() { return static_cast<int32_t>(U32()); }
  int64_t I64() {
    if (!Need(8)) return 0;
    uint64_t v = 0;
    for (int i = 0; i < 8; ++i) v |= static_cast<uint64_t>(*p++) << (8 * i);
    return static_cast<int64_t>(v);
  }
  std::string Str() {
    uint32_t n = U32();
    if (!Need(n)) return "";
    std::string s(reinterpret_cast<const char*>(p), n);
    p += n;
    return s;
  }
};

}  // namespace

std::vector<uint8_t> SerializeRequestList(const RequestList& rl) {
  Writer w;
  w.U8(rl.shutdown ? 1 : 0);
  w.U32(static_cast<uint32_t>(rl.requests.size()));
  for (const auto& r : rl.requests) {
    w.I32(r.rank);
    w.U8(r.op);
    w.U8(r.dtype);
    w.I32(r.root_rank);
    w.Str(r.name);
    w.U8(static_cast<uint8_t>(r.dims.size()));
    for (int64_t d : r.dims) w.I64(d);
    w.I32(r.p2p_peer);
    w.I32(r.p2p_tag);
    w.U32(static_cast<uint32_t>(r.stage_ranks.size()));
    for (int32_t sr : r.stage_ranks) w.I32(sr);
  }
  w.U32(static_cast<uint32_t>(rl.cache_bits.size()));
  for (uint32_t b : rl.cache_bits) w.U32(b);
  // Coordinator-tree aggregate section.  announce_us is either empty or
  // parallel to requests; serialize the actual length so the parse side
  // can restore the "no timestamps" (direct-star) form exactly.
  w.U32(static_cast<uint32_t>(rl.announce_us.size()));
  for (int64_t ts : rl.announce_us) w.I64(ts);
  w.U32(static_cast<uint32_t>(rl.bit_groups.size()));
  for (const auto& g : rl.bit_groups) {
    w.U32(g.slot);
    w.U32(static_cast<uint32_t>(g.ranks.size()));
    for (size_t i = 0; i < g.ranks.size(); ++i) {
      w.I32(g.ranks[i]);
      w.I64(i < g.announce_us.size() ? g.announce_us[i] : -1);
    }
  }
  w.U32(static_cast<uint32_t>(rl.frames_from.size()));
  for (int32_t r : rl.frames_from) w.I32(r);
  w.U32(static_cast<uint32_t>(rl.dead_ranks.size()));
  for (int32_t r : rl.dead_ranks) w.I32(r);
  w.U32(static_cast<uint32_t>(rl.steady_exits.size()));
  for (int32_t r : rl.steady_exits) w.I32(r);
  w.U8(rl.steady_exit);
  w.I64(rl.steady_epoch);
  w.I64(rl.steady_pos);
  w.I64(rl.membership_epoch);
  w.U8(rl.hb_report ? 1 : 0);
  return std::move(w.buf);
}

bool ParseRequestList(const std::vector<uint8_t>& buf, RequestList* rl) {
  Reader rd(buf);
  rl->shutdown = rd.U8() != 0;
  uint32_t n = rd.U32();
  rl->requests.clear();
  rl->requests.reserve(n);
  for (uint32_t i = 0; i < n && rd.ok; ++i) {
    Request r;
    r.rank = rd.I32();
    r.op = rd.U8();
    r.dtype = rd.U8();
    r.root_rank = rd.I32();
    r.name = rd.Str();
    uint8_t nd = rd.U8();
    for (uint8_t j = 0; j < nd; ++j) r.dims.push_back(rd.I64());
    r.p2p_peer = rd.I32();
    r.p2p_tag = rd.I32();
    uint32_t nsr = rd.U32();
    for (uint32_t j = 0; j < nsr && rd.ok; ++j)
      r.stage_ranks.push_back(rd.I32());
    rl->requests.push_back(std::move(r));
  }
  rl->cache_bits.clear();
  uint32_t nb = rd.U32();
  for (uint32_t i = 0; i < nb && rd.ok; ++i)
    rl->cache_bits.push_back(rd.U32());
  rl->announce_us.clear();
  uint32_t nts = rd.U32();
  for (uint32_t i = 0; i < nts && rd.ok; ++i)
    rl->announce_us.push_back(rd.I64());
  rl->bit_groups.clear();
  uint32_t ng = rd.U32();
  for (uint32_t i = 0; i < ng && rd.ok; ++i) {
    BitGroup g;
    g.slot = rd.U32();
    uint32_t nr = rd.U32();
    for (uint32_t j = 0; j < nr && rd.ok; ++j) {
      g.ranks.push_back(rd.I32());
      g.announce_us.push_back(rd.I64());
    }
    rl->bit_groups.push_back(std::move(g));
  }
  rl->frames_from.clear();
  uint32_t nf = rd.U32();
  for (uint32_t i = 0; i < nf && rd.ok; ++i)
    rl->frames_from.push_back(rd.I32());
  rl->dead_ranks.clear();
  uint32_t nd = rd.U32();
  for (uint32_t i = 0; i < nd && rd.ok; ++i)
    rl->dead_ranks.push_back(rd.I32());
  rl->steady_exits.clear();
  uint32_t nse = rd.U32();
  for (uint32_t i = 0; i < nse && rd.ok; ++i)
    rl->steady_exits.push_back(rd.I32());
  rl->steady_exit = rd.U8();
  rl->steady_epoch = rd.I64();
  rl->steady_pos = rd.I64();
  rl->membership_epoch = rd.I64();
  rl->hb_report = rd.U8() != 0;
  return rd.ok;
}

void SerializeHeartbeat(const HeartbeatFrame& hb, uint8_t out[16]) {
  Writer w;
  w.U32(hb.magic);
  w.U32(hb.sender_rank);
  w.U32(hb.epoch);
  w.U32(hb.seq);
  memcpy(out, w.buf.data(), kHeartbeatFrameBytes);
}

bool ParseHeartbeat(const uint8_t in[16], HeartbeatFrame* hb) {
  std::vector<uint8_t> buf(in, in + kHeartbeatFrameBytes);
  Reader rd(buf);
  hb->magic = rd.U32();
  hb->sender_rank = rd.U32();
  hb->epoch = rd.U32();
  hb->seq = rd.U32();
  return rd.ok &&
         (hb->magic == HeartbeatFrame().magic || hb->magic == kSuspectMagic ||
          hb->magic == kEchoMagic);
}

std::vector<uint8_t> SerializeResponseList(const ResponseList& rl) {
  Writer w;
  w.U8(rl.shutdown ? 1 : 0);
  w.I32(rl.abort_code);
  w.Str(rl.abort_message);
  w.U32(static_cast<uint32_t>(rl.responses.size()));
  for (const auto& r : rl.responses) {
    w.U8(r.type);
    w.U32(static_cast<uint32_t>(r.names.size()));
    for (const auto& nm : r.names) w.Str(nm);
    w.Str(r.error_message);
    w.U32(static_cast<uint32_t>(r.rank_dim0.size()));
    for (int64_t d : r.rank_dim0) w.I64(d);
    w.U8(r.compression);
    w.I32(r.p2p_src);
    w.I32(r.p2p_dst);
    w.I32(r.p2p_tag);
    w.U8(r.p2p_dtype);
    w.U32(static_cast<uint32_t>(r.p2p_dims.size()));
    for (int64_t d : r.p2p_dims) w.I64(d);
    w.U32(static_cast<uint32_t>(r.stage_ranks.size()));
    for (int32_t sr : r.stage_ranks) w.I32(sr);
  }
  w.U32(static_cast<uint32_t>(rl.cache_hits.size()));
  for (uint32_t h : rl.cache_hits) w.U32(h);
  w.U8((rl.tuned_present ? 1 : 0) | (rl.tuned_frozen ? 2 : 0));
  if (rl.tuned_present) {
    w.I64(rl.tuned_fusion_threshold);
    w.I64(rl.tuned_cycle_time_us);
    w.I64(rl.tuned_window);
    w.U8(rl.tuned_compression);
    w.I64(rl.tuned_cross_algo_threshold);
  }
  w.U8(rl.reshape_present ? 1 : 0);
  if (rl.reshape_present) {
    w.I64(rl.membership_epoch);
    w.I64(rl.reshape_cache_capacity);
    w.I64(rl.reshape_fusion_threshold);
    w.I64(rl.reshape_cycle_time_us);
    w.U8(rl.reshape_compression);
    w.I64(rl.reshape_compression_min_bytes);
    w.I64(rl.reshape_cross_algo_threshold);
    w.U32(static_cast<uint32_t>(rl.member_old_ranks.size()));
    for (size_t i = 0; i < rl.member_old_ranks.size(); ++i) {
      w.I32(rl.member_old_ranks[i]);
      w.Str(rl.member_endpoints[i]);
    }
    w.U32(static_cast<uint32_t>(rl.reshape_lost.size()));
    for (int32_t r : rl.reshape_lost) w.I32(r);
  }
  w.U8((rl.steady_present ? 1 : 0) | (rl.steady_revoke ? 2 : 0));
  if (rl.steady_present) {
    w.U32(static_cast<uint32_t>(rl.steady_pattern.size()));
    for (uint32_t s : rl.steady_pattern) w.U32(s);
    w.U32(static_cast<uint32_t>(rl.steady_groups.size()));
    for (uint32_t g : rl.steady_groups) w.U32(g);
  }
  return std::move(w.buf);
}

bool ParseResponseList(const std::vector<uint8_t>& buf, ResponseList* rl) {
  Reader rd(buf);
  rl->shutdown = rd.U8() != 0;
  rl->abort_code = rd.I32();
  rl->abort_message = rd.Str();
  uint32_t n = rd.U32();
  rl->responses.clear();
  rl->responses.reserve(n);
  for (uint32_t i = 0; i < n && rd.ok; ++i) {
    Response r;
    r.type = rd.U8();
    uint32_t nn = rd.U32();
    for (uint32_t j = 0; j < nn; ++j) r.names.push_back(rd.Str());
    r.error_message = rd.Str();
    uint32_t ns = rd.U32();
    for (uint32_t j = 0; j < ns; ++j) r.rank_dim0.push_back(rd.I64());
    r.compression = rd.U8();
    r.p2p_src = rd.I32();
    r.p2p_dst = rd.I32();
    r.p2p_tag = rd.I32();
    r.p2p_dtype = rd.U8();
    uint32_t npd = rd.U32();
    for (uint32_t j = 0; j < npd && rd.ok; ++j)
      r.p2p_dims.push_back(rd.I64());
    uint32_t ngr = rd.U32();
    for (uint32_t j = 0; j < ngr && rd.ok; ++j)
      r.stage_ranks.push_back(rd.I32());
    rl->responses.push_back(std::move(r));
  }
  rl->cache_hits.clear();
  uint32_t nh = rd.U32();
  for (uint32_t i = 0; i < nh && rd.ok; ++i)
    rl->cache_hits.push_back(rd.U32());
  uint8_t tuned_flags = rd.U8();
  rl->tuned_present = (tuned_flags & 1) != 0;
  rl->tuned_frozen = (tuned_flags & 2) != 0;
  if (rl->tuned_present) {
    rl->tuned_fusion_threshold = rd.I64();
    rl->tuned_cycle_time_us = rd.I64();
    rl->tuned_window = rd.I64();
    rl->tuned_compression = rd.U8();
    rl->tuned_cross_algo_threshold = rd.I64();
  }
  rl->member_old_ranks.clear();
  rl->member_endpoints.clear();
  rl->reshape_lost.clear();
  rl->reshape_present = rd.U8() != 0;
  if (rl->reshape_present) {
    rl->membership_epoch = rd.I64();
    rl->reshape_cache_capacity = rd.I64();
    rl->reshape_fusion_threshold = rd.I64();
    rl->reshape_cycle_time_us = rd.I64();
    rl->reshape_compression = rd.U8();
    rl->reshape_compression_min_bytes = rd.I64();
    rl->reshape_cross_algo_threshold = rd.I64();
    uint32_t nm = rd.U32();
    for (uint32_t i = 0; i < nm && rd.ok; ++i) {
      rl->member_old_ranks.push_back(rd.I32());
      rl->member_endpoints.push_back(rd.Str());
    }
    uint32_t nl = rd.U32();
    for (uint32_t i = 0; i < nl && rd.ok; ++i)
      rl->reshape_lost.push_back(rd.I32());
  }
  rl->steady_pattern.clear();
  rl->steady_groups.clear();
  uint8_t steady_flags = rd.U8();
  rl->steady_present = (steady_flags & 1) != 0;
  rl->steady_revoke = (steady_flags & 2) != 0;
  if (rl->steady_present) {
    uint32_t np = rd.U32();
    for (uint32_t i = 0; i < np && rd.ok; ++i)
      rl->steady_pattern.push_back(rd.U32());
    uint32_t ngr = rd.U32();
    for (uint32_t i = 0; i < ngr && rd.ok; ++i)
      rl->steady_groups.push_back(rd.U32());
  }
  return rd.ok;
}

}  // namespace hvdtpu
