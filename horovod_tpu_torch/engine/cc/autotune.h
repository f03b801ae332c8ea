// Online parameter autotuning (docs/performance.md#autotuning).
//
// The engine's two dominant performance knobs — the tensor-fusion
// threshold and the negotiation cycle time — default to static values no
// single workload agrees on (a 32-byte-allreduce transformer step wants a
// tight cycle, a 100 MB-gradient CNN step wants big fusion buckets).  The
// ParameterManager is the engine-side analogue of the reference's later
// ParameterManager autotuner: rank 0 scores each tuning window from the
// throughput the coordinator already observes (payload bytes of every
// negotiated collective / wall time over the window), proposes the next
// (fusion_threshold, cycle_time_ms) candidate, and the engine broadcasts
// it inside the existing coordinator response list so EVERY rank applies
// it at the same tick boundary — the same lockstep-mutation contract the
// negotiation response cache rides.
//
// Search policy: warmup (discard the first W windows) -> coordinate-
// descent hill-climb over a log-spaced grid, one knob at a time, with a
// best-so-far memory of every (point -> score) measured; when the score
// stops improving by more than epsilon for K consecutive windows the
// tuner FREEZES at the best point ever seen and the steady-state fast
// path runs untouched.  HVD_TPU_AUTOTUNE_FIX pins a knob by collapsing
// its grid to the fixed value.
//
// Threading: Record()/Tick() run on the engine thread only (rank 0 /
// single-process); the observability getters are called from Python API
// threads and are guarded by an internal mutex.
#pragma once

#include <array>
#include <chrono>
#include <cstdint>
#include <deque>
#include <map>
#include <mutex>
#include <string>
#include <utility>
#include <vector>

namespace hvdtpu {

// Log-spaced candidate grids.  Mirrored in Python
// (horovod_tpu/common/autotune.py) for docs and tests — keep in sync.
extern const std::vector<int64_t> kFusionGrid;   // bytes
extern const std::vector<double> kCycleGridMs;   // milliseconds
// Wire-compression axis (CompressionMode codes, none -> bf16 -> fp8):
// searched only when the job opted into compression at init — the tuner
// must never turn a lossy wire format on for a job that asked for exact
// fp32 (engine.cc pins the axis at the env value in that case).
extern const std::vector<int64_t> kCompressionGrid;
// Two-level cross-node ring-vs-tree boundary (bytes; buckets under it take
// the recursive-doubling tree exchange): searched only when the job runs
// the hierarchical topology — on the flat ring the knob is dead and
// engine.cc pins the axis at the env value.  0 = ring always.
extern const std::vector<int64_t> kCrossAlgoGrid;

class ParameterManager {
 public:
  struct Proposal {
    bool present = false;
    bool frozen = false;
    int64_t fusion_threshold = 0;
    int64_t cycle_time_us = 0;
    int64_t compression = 0;  // CompressionMode code
    int64_t cross_algo_threshold = 0;  // ring-vs-tree boundary, bytes
    int64_t window = 0;  // completed-window count when proposed
  };

  // `fix_fusion` / `fix_cycle_ms` / `fix_compression` / `fix_cross_algo`
  // pin a knob (< 0 = tune it); the initial values seed the search
  // (snapped to the nearest grid point in log space at the first
  // post-warmup broadcast).
  void Configure(bool enabled, int64_t warmup_windows, int64_t window_ops,
                 int64_t fix_fusion, double fix_cycle_ms,
                 int64_t fix_compression, int64_t fix_cross_algo,
                 int64_t init_fusion, double init_cycle_ms,
                 int64_t init_compression, int64_t init_cross_algo);

  bool enabled() const { return enabled_; }
  // Still searching: windows are being scored and candidates proposed.
  bool active() const { return enabled_ && !done_; }

  // Rank 0: account `n` negotiated collectives carrying `bytes` of
  // payload toward the current window (fresh negotiations and cache-bit
  // agreements both count; called where the coordinator aggregates
  // announces).
  void Record(int64_t bytes, int64_t n);

  // Rank 0, once per engine tick: closes the window when due and fills
  // `out` with the next candidate (or the freeze verdict).  `out->present`
  // stays false on ticks with nothing to broadcast.  `cur_fusion` /
  // `cur_cycle_ms` / `cur_compression` / `cur_cross_algo` are the
  // engine's currently APPLIED values — a manual injection that sets only
  // some knobs keeps the others at their applied values (which need not
  // be grid points).
  void Tick(std::chrono::steady_clock::time_point now, int64_t cur_fusion,
            double cur_cycle_ms, int64_t cur_compression,
            int64_t cur_cross_algo, Proposal* out);

  // Manual injection (hvd.autotune_set, the pluggable-policy seam): the
  // injected values are broadcast on the next tick and the search state
  // snaps to the nearest grid point so a resumed search continues from
  // there.  Values < 0 keep the current value for that knob.
  void Inject(int64_t fusion, double cycle_ms, int64_t compression,
              int64_t cross_algo);

  // Observability (any thread).
  int64_t windows() const;
  double best_score() const;
  // "window|fusion_bytes|cycle_us|score;..." — one entry per scored
  // window (the params the window ran under), bounded.
  std::string History() const;

 private:
  int64_t GridFusion() const { return axes_fusion_[idx_[0]]; }
  double GridCycleMs() const { return axes_cycle_[idx_[1]]; }
  int64_t GridCompression() const { return axes_comp_[idx_[2]]; }
  int64_t GridCrossAlgo() const { return axes_algo_[idx_[3]]; }
  Proposal MakeProposal(bool frozen);
  // Broadcast the snapped anchor point (or the freeze verdict when both
  // knobs are pinned); the measured score of the window that triggered
  // it is discarded — it ran under the raw initial params.
  void BroadcastAnchor(Proposal* out);
  void CloseWindow(double score, Proposal* out);
  // Advance the hill climb after measuring `score` at the current point;
  // fills `out` when the move (or freeze) changes the broadcast params.
  void Step(double score, Proposal* out);
  bool MoveOn(int axis, int dir);    // try idx_[axis] += dir; false if OOB
  void SwitchAxis(double last_score);
  void FreezeAtBest(Proposal* out);

  bool enabled_ = false;
  bool done_ = false;          // frozen (or nothing tunable)
  bool anchored_ = false;      // snapped anchor point broadcast yet?
  int64_t warmup_left_ = 0;
  int64_t window_ops_ = 32;

  std::vector<int64_t> axes_fusion_;
  std::vector<double> axes_cycle_;
  std::vector<int64_t> axes_comp_;
  std::vector<int64_t> axes_algo_;
  // Raw initial env values — what warmup windows actually run under
  // (the applied params change only at the first broadcast).
  int64_t init_fusion_ = 0;
  double init_cycle_ms_ = 0.0;
  int64_t init_comp_ = 0;
  int64_t init_algo_ = 0;
  int idx_[4] = {0, 0, 0, 0};  // grid point (fusion, cycle, comp, algo)
  int axis_ = 1;               // knob being climbed (cycle first: the
                               // idle-cadence win is the common case)
  int dir_ = -1;               // climb direction on axis_
  bool tried_flip_ = false;    // other direction already tried from anchor
  bool have_anchor_ = false;   // anchor_score_ valid for axis_
  double anchor_score_ = 0.0;  // best score at the anchor point of axis_
  int anchor_idx_ = 0;

  // Window accumulation (engine thread only).
  int64_t win_bytes_ = 0;
  int64_t win_ops_ = 0;
  bool win_open_ = false;
  std::chrono::steady_clock::time_point win_start_{};

  // Best-so-far memory over measured grid points: (score sum, samples).
  // The freeze verdict takes the argmax of per-point MEANS — repeated
  // visits (anchors are re-measured on every axis switch) average out
  // window noise instead of keeping a lucky spike.
  std::map<std::array<int, 4>, std::pair<double, int>> memory_;
  std::array<int, 4> best_point_{{0, 0, 0, 0}};
  bool have_best_ = false;
  int stall_windows_ = 0;

  // Manual injection mailbox (API thread -> engine thread).
  mutable std::mutex mu_;  // guards inject_*, windows_, best_score_, history_
  bool inject_pending_ = false;
  int64_t inject_fusion_ = -1;
  double inject_cycle_ms_ = -1.0;
  int64_t inject_comp_ = -1;
  int64_t inject_algo_ = -1;

  int64_t windows_ = 0;
  double best_score_ = 0.0;
  std::deque<std::string> history_;
};

}  // namespace hvdtpu
