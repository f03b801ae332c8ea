#include "flight.h"

namespace hvdtpu {

namespace {

// Interned-name bound: a pathological auto-named tensor stream must not
// grow the table without limit; names past the cap share one bucket (the
// ring entry still carries its event type, timestamp and arg).
constexpr size_t kMaxInternedNames = 4096;

}  // namespace

const char* FlightEventName(uint8_t event) {
  switch (event) {
    case FL_ENQUEUE:   return "enqueue";
    case FL_ANNOUNCE:  return "announce";
    case FL_CACHE_HIT: return "cache_hit";
    case FL_EXECUTE:   return "execute";
    case FL_ERROR:     return "error";
    case FL_TICK:      return "tick";
    case FL_STALL:     return "stall";
    case FL_ABORT:     return "abort";
    case FL_RESHAPE:   return "reshape";
    case FL_TUNE:      return "tune";
    case FL_COMPRESS:  return "compress";
    case FL_TOPOLOGY:  return "topology";
    case FL_STEADY:    return "steady";
    case FL_HEARTBEAT_MISS: return "heartbeat_miss";
    case FL_ANOMALY:   return "anomaly";
    case FL_TRANSPORT: return "transport";
    case FL_P2P:       return "p2p";
    default:           return "unknown";
  }
}

void FlightRecorder::Initialize(
    int64_t capacity, std::chrono::steady_clock::time_point epoch) {
  std::lock_guard<std::mutex> lk(mu_);
  enabled_ = capacity > 0;
  epoch_ = epoch;
  next_seq_ = 0;
  head_ = 0;
  ring_.clear();
  names_.clear();
  name_ids_.clear();
  if (!enabled_) return;
  if (capacity > 65536) capacity = 65536;
  ring_.assign(static_cast<size_t>(capacity), Entry());
  // id 0: "no tensor" (tick/abort/reshape events); id 1: intern overflow.
  names_.push_back("");
  names_.push_back("<other>");
}

int32_t FlightRecorder::InternLocked(const std::string& name) {
  if (name.empty()) return 0;
  auto it = name_ids_.find(name);
  if (it != name_ids_.end()) return it->second;
  if (names_.size() >= kMaxInternedNames) return 1;
  int32_t id = static_cast<int32_t>(names_.size());
  std::string clean;
  clean.reserve(name.size());
  for (char c : name) clean += (c == ';' || c == '|') ? '_' : c;
  names_.push_back(clean);
  name_ids_[name] = id;
  return id;
}

void FlightRecorder::Record(uint8_t event, const std::string& name,
                            int64_t arg) {
  std::lock_guard<std::mutex> lk(mu_);
  if (!enabled_) return;
  Entry& e = ring_[head_];
  e.seq = next_seq_++;
  e.ts_us = std::chrono::duration_cast<std::chrono::microseconds>(
                std::chrono::steady_clock::now() - epoch_)
                .count();
  e.event = event;
  e.name_id = InternLocked(name);
  e.arg = arg;
  head_ = (head_ + 1) % ring_.size();
  ++total_;
}

int64_t FlightRecorder::Events() const {
  std::lock_guard<std::mutex> lk(mu_);
  return total_;
}

std::string FlightRecorder::Dump() {
  std::lock_guard<std::mutex> lk(mu_);
  std::string out;
  if (!enabled_) return out;
  // Oldest entry sits at head_ once the ring has wrapped.
  const size_t n = ring_.size();
  for (size_t i = 0; i < n; ++i) {
    const Entry& e = ring_[(head_ + i) % n];
    if (e.seq < 0) continue;  // never written
    if (!out.empty()) out += ';';
    out += std::to_string(e.seq) + "|" + std::to_string(e.ts_us) + "|" +
           FlightEventName(e.event) + "|" +
           (e.name_id >= 0 && e.name_id < static_cast<int32_t>(names_.size())
                ? names_[e.name_id]
                : "") +
           "|" + std::to_string(e.arg);
  }
  return out;
}

}  // namespace hvdtpu
