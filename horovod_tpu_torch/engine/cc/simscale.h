// Simulated-scale negotiation harness (docs/performance.md
// #control-plane-scaling): run N engine-plane ranks IN ONE PROCESS over
// loopback TCP — each rank a full Engine instance with its own
// background thread and control/data sockets — and drive OP_NOOP
// negotiation cycles from per-rank driver threads.  NOOPs move no data,
// so the measured per-cycle latency is pure control-plane cost: the
// star-vs-tree fan-in and the decentralized steady state's zero-frame
// replay become measurable in CI at hundreds of ranks without hundreds
// of processes.
#pragma once

#include <string>

namespace hvdtpu {

// Runs the harness and returns a one-line JSON report:
//   {"ok":1,"size":N,"tree":0|1,"steady_entered":0|1,
//    "warm_p50_us":..,"warm_p90_us":..,
//    "steady_p50_us":..,"steady_p90_us":..,
//    "steady_frames_delta":..,"steady_cycles":..,
//    "coord_children":..,"negotiated_cycles":..}
// or {"ok":0,"error":"..."} on setup failure.  `ops_per_cycle` OP_NOOP
// collectives are enqueued-then-waited per cycle on every rank; cycle
// latency is measured on rank 0's driver.  `steady_threshold` 0 keeps
// the star/tree negotiating every cycle (the baseline curve);
// `coord_tree` toggles the sub-coordinator tree.  `base_port` seeds the
// loopback endpoints (size + 1 consecutive ports).
std::string SimScaleRun(int size, int local_size, int ops_per_cycle,
                        int warm_cycles, int steady_cycles,
                        long long steady_threshold, int coord_tree,
                        int base_port, double timeout_sec);

}  // namespace hvdtpu
