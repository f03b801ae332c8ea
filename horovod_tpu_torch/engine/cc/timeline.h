// Chrome-tracing timeline writer.  Same event model as the reference's
// Horovod Timeline (Horovod's horovod/common/timeline.{h,cc}): one
// trace "pid" per tensor name, NEGOTIATE -> op -> activity nesting, JSON
// written incrementally and flushed periodically; load the output in
// chrome://tracing or Perfetto.
//
// Cross-rank tracing (docs/timeline.md): EVERY rank writes its own file
// (the Python side resolves HOROVOD_TIMELINE's directory / %d forms to a
// per-rank path).  Timestamps are anchored to the engine's Init-time
// epoch, the coordinator measures each worker epoch's offset against its
// own (engine.cc ClockSync), and each file records its rank plus that
// offset as metadata — tools/timeline_merge.py uses them to fuse the
// per-rank files onto rank 0's clock.
#pragma once

#include <chrono>
#include <cstdint>
#include <fstream>
#include <mutex>
#include <string>
#include <unordered_map>
#include <vector>

namespace hvdtpu {

class Timeline {
 public:
  // `epoch` anchors every ts (µs since it); `rank` is recorded as an
  // "hvd_rank" metadata event so merged traces know who wrote what.
  void Initialize(const std::string& path, int rank,
                  std::chrono::steady_clock::time_point epoch);
  bool Enabled() const { return enabled_; }

  void NegotiateStart(const std::string& name, uint8_t op);
  // `ts_us` >= 0 stamps the instant at that epoch-time instead of "now":
  // under the coordinator tree, rank 0 receives announce timestamps
  // forwarded (clock-mapped) by the sub-coordinators, and the RANK_READY
  // instants must carry the TRUE announce times or the straggler report
  // (tools/timeline_merge.py) would attribute every skew to the
  // aggregate frame's arrival.
  void NegotiateRankReady(const std::string& name, int rank,
                          int64_t ts_us = -1);
  void NegotiateEnd(const std::string& name);
  void Start(const std::string& name, const std::string& op_name);
  void ActivityStart(const std::string& name, const std::string& activity);
  void ActivityEnd(const std::string& name);
  void End(const std::string& name, int64_t bytes);
  // Instant event ('i') on `name`'s row — the span API's trace_marker.
  void Instant(const std::string& name, const std::string& label);
  // "hvd_clock_sync" metadata: this rank's estimated clock offset against
  // rank 0 (µs; subtract from ts to land on rank 0's clock) and the RTT of
  // the winning probe (the error bound).  Flushed immediately so the merge
  // tool can align even a trace whose writer later crashed.
  void WriteClockSync(int64_t offset_us, int64_t rtt_us);
  // Flush buffered events to disk without closing (abort/crash paths:
  // post-mortem traces must parse, docs/timeline.md).
  void Flush();
  void Shutdown();

 private:
  void WriteEvent(const std::string& name, char phase, const std::string& args,
                  const std::string& category, int64_t ts_us = -1);
  int64_t TensorPid(const std::string& name);
  int64_t NowUs() const;

  bool enabled_ = false;
  std::ofstream file_;
  std::mutex mu_;
  std::unordered_map<std::string, int64_t> tensor_pids_;
  // Per-row monotonicity clamp: explicit timestamps (forwarded announce
  // times under the coordinator tree) may precede a row's last written
  // event by microseconds; Chrome-trace consumers (and the structural
  // validator) want non-decreasing ts per row.
  std::unordered_map<int64_t, int64_t> last_ts_by_pid_;
  // Per-row stack of open 'B' labels so every 'E' event can repeat its
  // opener's name — the structural-validation contract (tests require
  // ph/ts/pid/name on every row) without breaking Chrome's B/E pairing.
  std::unordered_map<std::string, std::vector<std::string>> open_labels_;
  std::chrono::steady_clock::time_point start_{};
  std::chrono::steady_clock::time_point last_flush_{};
};

}  // namespace hvdtpu
