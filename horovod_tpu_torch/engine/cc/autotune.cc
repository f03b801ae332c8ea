#include "autotune.h"

#include <algorithm>
#include <cmath>
#include <cstdio>

namespace hvdtpu {

// Log-spaced grids (powers of 4 for the threshold, ~half-decades for the
// cycle).  Spanning 64 KB..256 MB and 0.5..50 ms keeps the climb short —
// a handful of windows per axis — while bracketing every regime the
// benches exercise (negotiation-bound 32 B allreduces to 100 MB CNN
// gradient buckets).
const std::vector<int64_t> kFusionGrid = {
    64 << 10, 256 << 10, 1 << 20, 4 << 20, 16 << 20, 64 << 20, 256 << 20};
const std::vector<double> kCycleGridMs = {0.5, 1.0, 2.5, 5.0, 10.0, 25.0,
                                          50.0};
// CompressionMode codes ordered by wire aggressiveness (none 0, bf16 1,
// fp8 2): climbing +1 moves fewer bytes per bucket.
const std::vector<int64_t> kCompressionGrid = {0, 1, 2};
// Ring-vs-tree boundary for the two-level cross-node hop (bytes; buckets
// under the boundary take the recursive-doubling tree).  0 = ring always;
// the top end brackets the latency-bound bucket sizes the small-allreduce
// bench exercises.
const std::vector<int64_t> kCrossAlgoGrid = {0, 16 << 10, 64 << 10,
                                             256 << 10, 1 << 20};

namespace {

// Relative improvement required to count as "the job got faster": global
// progress below this for kFreezeStall consecutive windows freezes the
// search.  Move acceptance uses the tighter kEpsMove so plateaus
// terminate a climb quickly; the best-so-far memory protects the final
// choice from noise-accepted moves.
constexpr double kEpsImprove = 0.05;
constexpr double kEpsMove = 0.02;
constexpr int kFreezeStall = 6;
// A window must span at least this much wall time: at wire-speed op rates
// an op-count-only window would close in microseconds and score pure
// scheduler noise.  50 ms spans several steps of a fast configuration —
// the single-step windows this replaced measured noisily enough to
// freeze the search at the wrong grid point every few runs.
constexpr double kMinWindowSec = 0.05;
constexpr size_t kHistoryCap = 512;

template <typename T>
int SnapLog(const std::vector<T>& grid, double value) {
  if (value <= 0) return 0;
  int best = 0;
  double best_d = -1;
  for (size_t i = 0; i < grid.size(); ++i) {
    if (static_cast<double>(grid[i]) <= 0) continue;  // log(0): see below
    double d = std::fabs(std::log(static_cast<double>(grid[i])) -
                         std::log(value));
    if (best_d < 0 || d < best_d) {
      best_d = d;
      best = static_cast<int>(i);
    }
  }
  // A non-positive grid point (the cross-algo grid's "0 = ring always")
  // is only reachable by a non-positive value, handled above.
  return best;
}

}  // namespace

void ParameterManager::Configure(bool enabled, int64_t warmup_windows,
                                 int64_t window_ops, int64_t fix_fusion,
                                 double fix_cycle_ms,
                                 int64_t fix_compression,
                                 int64_t fix_cross_algo,
                                 int64_t init_fusion, double init_cycle_ms,
                                 int64_t init_compression,
                                 int64_t init_cross_algo) {
  std::lock_guard<std::mutex> lk(mu_);
  enabled_ = enabled;
  done_ = !enabled;
  warmup_left_ = std::max<int64_t>(warmup_windows, 0);
  window_ops_ = std::max<int64_t>(window_ops, 1);
  axes_fusion_ = fix_fusion >= 0 ? std::vector<int64_t>{fix_fusion}
                                 : kFusionGrid;
  axes_cycle_ = fix_cycle_ms >= 0 ? std::vector<double>{fix_cycle_ms}
                                  : kCycleGridMs;
  axes_comp_ = fix_compression >= 0
                   ? std::vector<int64_t>{fix_compression}
                   : kCompressionGrid;
  axes_algo_ = fix_cross_algo >= 0 ? std::vector<int64_t>{fix_cross_algo}
                                   : kCrossAlgoGrid;
  init_fusion_ = init_fusion;
  init_cycle_ms_ = init_cycle_ms;
  init_comp_ = init_compression;
  init_algo_ = init_cross_algo;
  idx_[0] = SnapLog(axes_fusion_, static_cast<double>(init_fusion));
  idx_[1] = SnapLog(axes_cycle_, init_cycle_ms);
  idx_[2] = 0;
  for (size_t i = 0; i < axes_comp_.size(); ++i)
    if (axes_comp_[i] == init_compression) idx_[2] = static_cast<int>(i);
  idx_[3] = SnapLog(axes_algo_, static_cast<double>(init_cross_algo));
  // Cycle first, climbing down: the idle-cadence co-arrival sleep is the
  // dominant knob for the negotiation-bound steady state (docs/
  // performance.md), and a too-high cycle drowns any fusion signal.
  axis_ = axes_cycle_.size() > 1 ? 1
          : axes_fusion_.size() > 1 ? 0
          : axes_comp_.size() > 1  ? 2
                                    : 3;
  dir_ = axis_ == 1 ? -1 : +1;
  tried_flip_ = false;
  have_anchor_ = false;
  anchored_ = false;
  win_bytes_ = win_ops_ = 0;
  win_open_ = false;
  memory_.clear();
  have_best_ = false;
  stall_windows_ = 0;
  inject_pending_ = false;
  windows_ = 0;
  best_score_ = 0.0;
  history_.clear();
}

void ParameterManager::Record(int64_t bytes, int64_t n) {
  if (!active()) return;
  if (!win_open_) {
    // The window opens at its first op, not at the previous close: the
    // score is collective throughput while work flows, and a long idle
    // stretch between steps must not dilute it.
    win_open_ = true;
    win_start_ = std::chrono::steady_clock::now();
  }
  win_bytes_ += bytes;
  win_ops_ += n;
}

ParameterManager::Proposal ParameterManager::MakeProposal(bool frozen) {
  Proposal p;
  p.present = true;
  p.frozen = frozen;
  p.fusion_threshold = GridFusion();
  p.cycle_time_us = static_cast<int64_t>(GridCycleMs() * 1000.0);
  p.compression = GridCompression();
  p.cross_algo_threshold = GridCrossAlgo();
  std::lock_guard<std::mutex> lk(mu_);
  p.window = windows_;
  return p;
}

void ParameterManager::Inject(int64_t fusion, double cycle_ms,
                              int64_t compression, int64_t cross_algo) {
  std::lock_guard<std::mutex> lk(mu_);
  inject_pending_ = true;
  inject_fusion_ = fusion;
  inject_cycle_ms_ = cycle_ms;
  inject_comp_ = compression;
  inject_algo_ = cross_algo;
}

void ParameterManager::Tick(std::chrono::steady_clock::time_point now,
                            int64_t cur_fusion, double cur_cycle_ms,
                            int64_t cur_compression,
                            int64_t cur_cross_algo, Proposal* out) {
  {
    // Manual injection (hvd.autotune_set) broadcasts exactly the caller's
    // values this tick — works with the tuner disabled or frozen (the
    // pluggable-policy seam).  The search, if live, resumes from the
    // nearest grid point with a fresh window.  An unset knob keeps the
    // engine's applied value, NOT a grid snap — injecting one knob must
    // not silently move the others.
    std::lock_guard<std::mutex> lk(mu_);
    if (inject_pending_) {
      inject_pending_ = false;
      int64_t fusion = inject_fusion_ >= 0 ? inject_fusion_ : cur_fusion;
      double cycle = inject_cycle_ms_ >= 0 ? inject_cycle_ms_
                                           : cur_cycle_ms;
      int64_t comp = inject_comp_ >= 0 ? inject_comp_ : cur_compression;
      int64_t algo = inject_algo_ >= 0 ? inject_algo_ : cur_cross_algo;
      if (inject_fusion_ >= 0)
        idx_[0] = SnapLog(axes_fusion_, static_cast<double>(fusion));
      if (inject_cycle_ms_ >= 0) idx_[1] = SnapLog(axes_cycle_, cycle);
      if (inject_comp_ >= 0)
        for (size_t i = 0; i < axes_comp_.size(); ++i)
          if (axes_comp_[i] == comp) idx_[2] = static_cast<int>(i);
      if (inject_algo_ >= 0)
        idx_[3] = SnapLog(axes_algo_, static_cast<double>(algo));
      have_anchor_ = false;
      tried_flip_ = false;
      // De-anchor: the next window runs under the EXACT injected values,
      // which may sit off-grid — its score must be discarded (and the
      // snapped anchor re-broadcast) rather than attributed to the grid
      // point in memory_/history_, same as the raw initial params.
      anchored_ = false;
      win_open_ = false;
      win_bytes_ = win_ops_ = 0;
      out->present = true;
      // "frozen" means a search CONVERGED; a disabled tuner's done_
      // state must not let a manual injection report one.
      out->frozen = enabled_ && done_;
      out->fusion_threshold = fusion;
      out->cycle_time_us = static_cast<int64_t>(cycle * 1000.0);
      out->compression = comp;
      out->cross_algo_threshold = algo;
      out->window = windows_;
      return;
    }
  }
  if (!active() || !win_open_) return;
  double elapsed =
      std::chrono::duration<double>(now - win_start_).count();
  if (win_ops_ < window_ops_ || elapsed < kMinWindowSec) return;
  // Score: payload bytes negotiated per second, with a 1-byte-per-op
  // floor so windows of negotiation-only agreements (the XLA plane's
  // cached metadata no-ops move zero coordinator-visible bytes) still
  // score proportionally to op throughput.
  double score = static_cast<double>(win_bytes_ + win_ops_) / elapsed;
  win_open_ = false;
  win_bytes_ = win_ops_ = 0;
  CloseWindow(score, out);
}

void ParameterManager::CloseWindow(double score, Proposal* out) {
  {
    std::lock_guard<std::mutex> lk(mu_);
    ++windows_;
    // History records the params the window actually RAN under: before
    // the anchor broadcast that is the raw (un-snapped) initial env
    // values, not the grid point they snap to.
    int64_t fus = anchored_ ? GridFusion() : init_fusion_;
    double cyc = anchored_ ? GridCycleMs() : init_cycle_ms_;
    int64_t cmp = anchored_ ? GridCompression() : init_comp_;
    int64_t alg = anchored_ ? GridCrossAlgo() : init_algo_;
    char buf[144];
    snprintf(buf, sizeof(buf), "%lld|%lld|%lld|%lld|%lld|%.1f",
             static_cast<long long>(windows_),
             static_cast<long long>(fus),
             static_cast<long long>(cyc * 1000.0),
             static_cast<long long>(cmp),
             static_cast<long long>(alg), score);
    history_.emplace_back(buf);
    while (history_.size() > kHistoryCap) history_.pop_front();
  }
  if (warmup_left_ > 0) {
    // Warmup windows are discarded: they ran under the raw (un-snapped)
    // initial params and include negotiation cold start.  The last one
    // broadcasts the snapped anchor point so the search measures grid
    // values from here on.
    if (--warmup_left_ == 0) BroadcastAnchor(out);
    return;
  }
  if (!anchored_) {
    // HVD_TPU_AUTOTUNE_WARMUP=0: the snapped anchor was never broadcast,
    // and this window ran under the raw initial params — broadcasting
    // the snap now and DISCARDING the score keeps a raw-params
    // measurement from being attributed to the grid point in memory_.
    BroadcastAnchor(out);
    return;
  }
  Step(score, out);
}

void ParameterManager::BroadcastAnchor(Proposal* out) {
  anchored_ = true;
  if (axes_fusion_.size() == 1 && axes_cycle_.size() == 1 &&
      axes_comp_.size() == 1 && axes_algo_.size() == 1) {
    // Every knob pinned: nothing to search.  Broadcast the pinned point
    // once, frozen.
    FreezeAtBest(out);
  } else {
    *out = MakeProposal(false);
  }
}

void ParameterManager::Step(double score, Proposal* out) {
  std::array<int, 4> point{{idx_[0], idx_[1], idx_[2], idx_[3]}};
  auto& mem = memory_[point];
  mem.first += score;
  mem.second += 1;
  if (!have_best_ || score > best_score_ * (1.0 + kEpsImprove)) {
    have_best_ = true;
    best_point_ = point;
    stall_windows_ = 0;
    std::lock_guard<std::mutex> lk(mu_);
    best_score_ = std::max(best_score_, score);
  } else {
    ++stall_windows_;
  }
  if (stall_windows_ >= kFreezeStall) {
    FreezeAtBest(out);
    return;
  }
  if (!have_anchor_) {
    // This window measured the anchor of the current axis.
    have_anchor_ = true;
    anchor_score_ = score;
    anchor_idx_ = idx_[axis_];
    tried_flip_ = false;
    if (MoveOn(axis_, dir_)) {
      *out = MakeProposal(false);
    } else if (MoveOn(axis_, -dir_)) {
      dir_ = -dir_;
      *out = MakeProposal(false);
    } else {
      SwitchAxis(score);
      if (!done_) *out = MakeProposal(false);
      else FreezeAtBest(out);
    }
    return;
  }
  // This window measured a moved-to point.
  if (score > anchor_score_ * (1.0 + kEpsMove)) {
    // Improvement: keep climbing the same direction.  The opposite
    // direction is now known worse (it leads back through the old
    // anchor), so a later rejection ends this axis instead of flipping.
    anchor_score_ = score;
    anchor_idx_ = idx_[axis_];
    tried_flip_ = true;
    if (MoveOn(axis_, dir_)) {
      *out = MakeProposal(false);
    } else {
      SwitchAxis(score);
      if (!done_) *out = MakeProposal(false);
      else FreezeAtBest(out);
    }
    return;
  }
  // Worse (or flat): step back to the anchor; try the other direction
  // once, else hand the climb to the other knob.
  idx_[axis_] = anchor_idx_;
  if (!tried_flip_ && MoveOn(axis_, -dir_)) {
    tried_flip_ = true;
    dir_ = -dir_;
    *out = MakeProposal(false);
    return;
  }
  SwitchAxis(anchor_score_);
  if (!done_) *out = MakeProposal(false);
  else FreezeAtBest(out);
}

bool ParameterManager::MoveOn(int axis, int dir) {
  int n = axis == 0   ? static_cast<int>(axes_fusion_.size())
          : axis == 1 ? static_cast<int>(axes_cycle_.size())
          : axis == 2 ? static_cast<int>(axes_comp_.size())
                      : static_cast<int>(axes_algo_.size());
  int next = idx_[axis] + dir;
  if (next < 0 || next >= n) return false;
  idx_[axis] = next;
  return true;
}

void ParameterManager::SwitchAxis(double last_score) {
  // Hand the climb to the next knob; the measurement of the CURRENT
  // point becomes its anchor, so no window is wasted re-measuring.
  for (int attempt = 0; attempt < 4; ++attempt) {
    axis_ = (axis_ + 1) % 4;
    // Heuristic first direction: bigger fusion buckets, tighter cycle,
    // more aggressive wire compression, wider tree boundary.
    dir_ = axis_ == 1 ? -1 : +1;
    have_anchor_ = true;
    anchor_score_ = last_score;
    anchor_idx_ = idx_[axis_];
    tried_flip_ = false;
    if (MoveOn(axis_, dir_)) return;
    if (MoveOn(axis_, -dir_)) {
      dir_ = -dir_;
      return;
    }
    // This axis is pinned (single-point grid); try the next one.
  }
  // No knob can move: the search space is exhausted.
  done_ = true;
}

void ParameterManager::FreezeAtBest(Proposal* out) {
  // Freeze at the argmax of MEAN score over everything measured.
  // best_point_ only tracks >kEpsImprove jumps (the stall detector's
  // view), so a run of small accepted moves can leave the real best only
  // in memory_; means, not maxes, keep one lucky window from deciding
  // the job's permanent parameters.
  const std::array<int, 4>* argmax = nullptr;
  double argmax_score = 0.0;
  for (const auto& kv : memory_) {
    double mean = kv.second.first / kv.second.second;
    if (argmax == nullptr || mean > argmax_score) {
      argmax = &kv.first;
      argmax_score = mean;
    }
  }
  if (argmax != nullptr) {
    for (int a = 0; a < 4; ++a) idx_[a] = (*argmax)[a];
    // The reported best score must describe the FROZEN point: assign the
    // argmax mean outright — best_score_ may hold a lucky spike from a
    // point the mean ranking rejected.
    std::lock_guard<std::mutex> lk(mu_);
    best_score_ = argmax_score;
  } else if (have_best_) {
    for (int a = 0; a < 4; ++a) idx_[a] = best_point_[a];
  }
  done_ = true;
  *out = MakeProposal(true);
}

int64_t ParameterManager::windows() const {
  std::lock_guard<std::mutex> lk(mu_);
  return windows_;
}

double ParameterManager::best_score() const {
  std::lock_guard<std::mutex> lk(mu_);
  return best_score_;
}

std::string ParameterManager::History() const {
  std::lock_guard<std::mutex> lk(mu_);
  std::string out;
  for (const auto& e : history_) {
    if (!out.empty()) out += ';';
    out += e;
  }
  return out;
}

}  // namespace hvdtpu
