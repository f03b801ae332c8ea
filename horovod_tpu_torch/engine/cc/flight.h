// Flight recorder (postmortem plane, docs/troubleshooting.md#reading-a-
// postmortem): a fixed-size, always-on ring of recent control-plane events
// per rank, in the spirit of the NCCL/PyTorch flight recorder.  The engine
// records enqueue / announce / cache-hit / execute / tick / stall / abort /
// reshape / tune transitions with epoch-anchored timestamps and interned
// tensor names; on every typed abort the Python side drains the ring into
// HVD_TPU_POSTMORTEM_DIR/rank-N.json, so a crashed or hung job leaves a
// self-explaining record of what each rank was doing in its final seconds.
//
// Cost discipline: recording is one short mutex hold plus an intern-map
// lookup — a handful of control-plane events per collective, against the
// microseconds a negotiation tick costs (the <2% steady-state overhead
// budget the acceptance bench pins).  HVD_TPU_FLIGHT_EVENTS sizes the ring
// (default 512); 0 disables recording entirely.
#pragma once

#include <chrono>
#include <cstdint>
#include <mutex>
#include <string>
#include <unordered_map>
#include <vector>

namespace hvdtpu {

// Event codes.  Keep in sync with horovod_tpu/common/postmortem.py (the
// Python side parses the *names* from Dump(), so new codes only need a
// name here).
enum FlightEventType : uint8_t {
  FL_ENQUEUE = 0,    // collective submitted to the engine (arg: handle)
  FL_ANNOUNCE = 1,   // full string request drained to the coordinator
  FL_CACHE_HIT = 2,  // repeat announced as a cache bit (arg: slot)
  FL_EXECUTE = 3,    // response executed (arg: fused tensor count)
  FL_ERROR = 4,      // response carried a typed error
  FL_TICK = 5,       // a tick that moved work closed (arg: tick index)
  FL_STALL = 6,      // rank-0 stall sweep warned (arg: stalled seconds)
  FL_ABORT = 7,      // coordinated abort latched (arg: status code)
  FL_RESHAPE = 8,    // elastic membership adopted (arg: new epoch)
  FL_TUNE = 9,       // lockstep parameter broadcast applied (arg: fusion)
  FL_COMPRESS = 10,  // wire-compression mode armed / changed (arg: mode)
  FL_TOPOLOGY = 11,  // two-level cross-node algorithm switched
                     // (arg: 1 = tree, 0 = ring; name = first bucket name)
  FL_STEADY = 12,    // decentralized steady state entered/exited
                     // (name: "enter" with arg = pattern length, or the
                     // exit reason with arg = the epoch it happened at) —
                     // the record that explains why a postmortem shows
                     // zero coordinator traffic before a hang
  FL_HEARTBEAT_MISS = 13,  // data-plane heartbeat detector flagged a
                           // silent peer (arg: the peer rank; name:
                           // "flag" when first flagged, "report" when
                           // the report frame went up, "local-abort"
                           // when the grace deadline escalated locally)
  FL_ANOMALY = 14,  // online anomaly detector emitted a typed verdict
                    // (name: "slow_link(A-B)" / "straggler(rank)" /
                    // "cache_degraded" / "slow_phase(phase)"; arg: the
                    // verdict-kind index) — the postmortem record that
                    // says WHERE the job was slow before it died
  FL_TRANSPORT = 15,  // shared-memory transport armed for the node-local
                      // ring (name: "shm"; arg: per-direction ring bytes)
  FL_P2P = 16,  // point-to-point transfer executed (docs/pipeline.md;
                // name: the tensor; arg: payload bytes, negative for a
                // receive so one ring entry distinguishes direction)
};

const char* FlightEventName(uint8_t event);

class FlightRecorder {
 public:
  // (Re-)arms the recorder for one engine lifetime: the ring and the
  // intern table restart (old entries carry a dead epoch's timestamps),
  // the cumulative event counter survives — the metrics contract every
  // engine counter follows (engine.h StallEvents).
  void Initialize(int64_t capacity,
                  std::chrono::steady_clock::time_point epoch);
  bool Enabled() const { return enabled_; }
  void Record(uint8_t event, const std::string& name, int64_t arg);
  // Process-cumulative count of recorded events (survives re-init).
  int64_t Events() const;
  // Ring snapshot, oldest first: "seq|ts_us|event|name|arg;..." with the
  // separators sanitized out of tensor names.  Non-destructive — the ring
  // keeps recording; postmortem writers and tests both read it.
  std::string Dump();

 private:
  struct Entry {
    int64_t seq = -1;  // -1 = never written
    int64_t ts_us = 0;
    uint8_t event = 0;
    int32_t name_id = 0;
    int64_t arg = 0;
  };
  int32_t InternLocked(const std::string& name);

  mutable std::mutex mu_;
  bool enabled_ = false;
  int64_t total_ = 0;    // cumulative across engine lifetimes
  int64_t next_seq_ = 0; // per-lifetime ring sequence
  size_t head_ = 0;      // next write slot
  std::vector<Entry> ring_;
  std::vector<std::string> names_;
  std::unordered_map<std::string, int32_t> name_ids_;
  std::chrono::steady_clock::time_point epoch_{};
};

}  // namespace hvdtpu
