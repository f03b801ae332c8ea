#include "simscale.h"

#include <arpa/inet.h>
#include <netinet/in.h>
#include <sys/socket.h>
#include <unistd.h>

#include <algorithm>
#include <atomic>
#include <chrono>
#include <cmath>
#include <memory>
#include <thread>
#include <vector>

#include "engine.h"
#include "net.h"

namespace hvdtpu {

namespace {

int64_t NowUs() {
  return std::chrono::duration_cast<std::chrono::microseconds>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

double Pct(std::vector<int64_t>& v, double q) {
  if (v.empty()) return 0.0;
  std::sort(v.begin(), v.end());
  size_t idx = static_cast<size_t>(q * (v.size() - 1) + 0.5);
  return static_cast<double>(v[std::min(idx, v.size() - 1)]);
}

// Probe-bindable loopback port at or after `*next` (advancing it), or
// -1 when the scan runs out.  A fixed contiguous block collides with
// whatever ephemeral connections the host happens to hold (a single
// taken port stalls the whole rendezvous to its accept timeout); the
// engines all live in this process, so the endpoint list can simply
// carry whichever ports probe free.
int ProbeFreePort(int* next) {
  for (; *next < 65000; ++*next) {
    int fd = socket(AF_INET, SOCK_STREAM, 0);
    if (fd < 0) return -1;
    int one = 1;
    setsockopt(fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
    sockaddr_in addr{};
    addr.sin_family = AF_INET;
    // Probe exactly what the engine's Listen will bind (0.0.0.0): a
    // port held on a non-loopback interface passes a loopback-only
    // probe and then fails the real bind.
    addr.sin_addr.s_addr = htonl(INADDR_ANY);
    addr.sin_port = htons(static_cast<uint16_t>(*next));
    bool ok = bind(fd, reinterpret_cast<sockaddr*>(&addr),
                   sizeof(addr)) == 0;
    close(fd);
    if (ok) return (*next)++;
  }
  return -1;
}

// Parse field `idx` of the '|'-separated ControlInfo string.
int64_t InfoField(const std::string& info, int idx) {
  size_t pos = 0;
  for (int i = 0; i < idx; ++i) {
    pos = info.find('|', pos);
    if (pos == std::string::npos) return 0;
    ++pos;
  }
  return atoll(info.c_str() + pos);
}

}  // namespace

std::string SimScaleRun(int size, int local_size, int ops_per_cycle,
                        int warm_cycles, int steady_cycles,
                        long long steady_threshold, int coord_tree,
                        int base_port, double timeout_sec) {
  if (size < 2 || size > 1024 || ops_per_cycle < 1 || local_size < 1 ||
      size % local_size != 0)
    return "{\"ok\":0,\"error\":\"bad harness geometry\"}";
  // Allocate the fleet's ports BELOW the kernel's ephemeral range when
  // it leaves room: the rendezvous storm's own outgoing connections
  // draw ephemeral source ports, and a probed-free port inside that
  // range can be stolen as somebody's source port in the window between
  // the probe and the engine's bind (observed as one-in-few 256-rank
  // init failures).  Ports under the range can only collide with real
  // listeners, which the probe sees reliably.
  int eph_lo = 32768;
  if (FILE* f = fopen("/proc/sys/net/ipv4/ip_local_port_range", "r")) {
    int a, b;
    if (fscanf(f, "%d %d", &a, &b) == 2) eph_lo = a;
    fclose(f);
  }
  int scan;
  if (eph_lo - 1100 > size + 8) {
    int span = eph_lo - 1100 - (size + 8);
    scan = 1100 + (base_port > 0 ? base_port % span : 0);
  } else {
    scan = base_port > 0 ? base_port : 20000;
  }
  int coord_port = ProbeFreePort(&scan);
  if (coord_port < 0)
    return "{\"ok\":0,\"error\":\"no free loopback ports\"}";
  std::string coord_ep = "127.0.0.1:" + std::to_string(coord_port);
  std::vector<std::string> data_eps;
  for (int r = 0; r < size; ++r) {
    int p = ProbeFreePort(&scan);
    if (p < 0) return "{\"ok\":0,\"error\":\"no free loopback ports\"}";
    data_eps.push_back("127.0.0.1:" + std::to_string(p));
  }

  std::vector<std::unique_ptr<Engine>> engines;
  for (int r = 0; r < size; ++r) engines.emplace_back(new Engine());

  // Concurrent Init: the socket rendezvous blocks until every rank
  // connected, so all N must run simultaneously.
  std::atomic<int> init_fail{-1};
  std::vector<std::string> init_errs(size);
  {
    std::vector<std::thread> ts;
    for (int r = 0; r < size; ++r)
      ts.emplace_back([&, r]() {
        EngineOptions o;
        o.rank = r;
        o.size = size;
        o.local_rank = r % local_size;
        o.local_size = local_size;
        o.coord_endpoint = coord_ep;
        o.data_endpoints = data_eps;
        o.cycle_time_ms = 1.0;
        o.stall_warning_sec = 600.0;
        // The harness's own hang watchdog: a wedged negotiation aborts
        // typed instead of deadlocking the bench process.
        o.collective_timeout_sec = timeout_sec;
        o.cache_capacity = 1024;
        o.coord_tree = coord_tree != 0;
        o.steady_threshold = steady_threshold;
        if (engines[r]->Init(o, &init_errs[r]) != 0) init_fail.store(r);
      });
    for (auto& t : ts) t.join();
  }
  if (init_fail.load() >= 0) {
    int r = init_fail.load();
    std::string msg = init_errs[r];
    for (auto& c : msg)
      if (c == '"' || c == '\\' || c == '\n') c = ' ';
    for (auto& e : engines) e->Shutdown();
    return "{\"ok\":0,\"error\":\"rank " + std::to_string(r) +
           " init failed: " + msg + "\"}";
  }

  // Driver threads: per cycle, enqueue-all-then-wait a fixed set of
  // NOOP names (the XLA-metadata negotiation pattern at scale).  Rank
  // 0's driver records per-cycle enqueue->complete latency.  Drivers
  // PACE between cycles: on real hardware every rank is its own host,
  // but here hundreds of rank fleets share one machine, and an unpaced
  // free-run saturates the cores so the measured "cycle latency" is the
  // simulation's run-queue depth, not the control plane.  The pace gap
  // (the step's compute time, in a real job) is excluded from the
  // measurement and SCALES with the fleet so the simulation's aggregate
  // wake rate — its CPU footprint on this one machine — stays constant
  // across sizes; what the cells compare is the measured per-cycle
  // control-plane cost, which the pace sits outside of.
  const auto kPace =
      std::chrono::microseconds(3000 * std::max(1, size / 16));
  const int total_cycles = warm_cycles + steady_cycles;
  std::vector<int64_t> cycle_us(total_cycles, 0);
  std::atomic<bool> drive_fail{false};
  // Frame counters are snapshotted per rank the first cycle AFTER that
  // rank's engine reports steady (so a late arming never counts tail
  // negotiation frames into the delta), falling back to the warm/steady
  // boundary when steady never arms — then the delta is the star
  // baseline's per-cycle frame cost, which is the point of comparison.
  std::vector<int64_t> frames_at_boundary(size, -1);
  {
    std::vector<std::thread> ts;
    for (int r = 0; r < size; ++r)
      ts.emplace_back([&, r]() {
        Engine* e = engines[r].get();
        std::vector<int64_t> dims{1};
        for (int c = 0; c < total_cycles && !drive_fail.load(); ++c) {
          if (frames_at_boundary[r] < 0 &&
              (e->SteadyActive() || c == warm_cycles))
            frames_at_boundary[r] = e->CtrlFramesSent();
          int64_t t0 = NowUs();
          std::vector<int64_t> handles;
          handles.reserve(ops_per_cycle);
          for (int k = 0; k < ops_per_cycle; ++k) {
            int64_t h = e->Enqueue(OP_NOOP, "sim." + std::to_string(k),
                                   nullptr, nullptr, dims, HVD_FLOAT32, -1,
                                   false);
            if (h < 0) {
              drive_fail.store(true);
              return;
            }
            handles.push_back(h);
          }
          for (int64_t h : handles) {
            if (e->Wait(h) != ST_OK) {
              drive_fail.store(true);
              return;
            }
            e->Release(h);
          }
          if (r == 0) cycle_us[c] = NowUs() - t0;
          std::this_thread::sleep_for(kPace);
        }
      });
    for (auto& t : ts) t.join();
  }

  // Post-run accounting BEFORE shutdown (shutdown frames would pollute
  // the steady-frame delta).
  bool steady_entered = false;
  int64_t steady_cycle_count = 0;
  int64_t frames_delta_max = 0;
  for (int r = 0; r < size; ++r) {
    std::string info = engines[r]->ControlInfo();
    steady_entered = steady_entered || InfoField(info, 3) != 0 ||
                     InfoField(info, 6) > 0;  // active now, or entered
    steady_cycle_count = std::max(steady_cycle_count, InfoField(info, 9));
    if (frames_at_boundary[r] >= 0)
      frames_delta_max =
          std::max(frames_delta_max,
                   engines[r]->CtrlFramesSent() - frames_at_boundary[r]);
  }
  int64_t coord_children = InfoField(engines[0]->ControlInfo(), 1);
  int64_t negotiated = InfoField(engines[0]->ControlInfo(), 10);
  // Heartbeat-overhead surface (docs/performance.md#control-plane-
  // scaling): the detector rides env (HVD_TPU_HEARTBEAT_MS), so the
  // bench toggles it per cell and compares steady p50s; the frame count
  // proves which regime each cell actually ran in.  clock_fanin is rank
  // 0's init clock-sync probe count — O(direct children), the
  // tree-relay satellite's assert surface.
  int64_t hb_frames_sent = 0;
  for (int r = 0; r < size; ++r)
    hb_frames_sent = std::max(
        hb_frames_sent, InfoField(engines[r]->LivenessInfo(), 2));
  int64_t clock_fanin = InfoField(engines[0]->LivenessInfo(), 6);

  bool failed = drive_fail.load();
  {
    std::vector<std::thread> ts;
    for (auto& e : engines)
      ts.emplace_back([&e]() { e->Shutdown(); });
    for (auto& t : ts) t.join();
  }
  engines.clear();
  if (failed)
    return "{\"ok\":0,\"error\":\"a driver saw a failed collective "
           "(timeout or abort) - see stderr\"}";

  std::vector<int64_t> warm(cycle_us.begin() + std::min(2, warm_cycles),
                            cycle_us.begin() + warm_cycles);
  std::vector<int64_t> steady(cycle_us.begin() + warm_cycles,
                              cycle_us.end());
  char out[640];
  snprintf(out, sizeof(out),
           "{\"ok\":1,\"size\":%d,\"tree\":%d,\"steady_entered\":%d,"
           "\"warm_p50_us\":%.1f,\"warm_p90_us\":%.1f,"
           "\"steady_p50_us\":%.1f,\"steady_p90_us\":%.1f,"
           "\"steady_frames_delta\":%lld,\"steady_cycles\":%lld,"
           "\"coord_children\":%lld,\"negotiated_cycles\":%lld,"
           "\"hb_frames_sent\":%lld,\"clock_fanin\":%lld,"
           "\"link_sends\":%lld}",
           size, coord_tree ? 1 : 0, steady_entered ? 1 : 0,
           Pct(warm, 0.5), Pct(warm, 0.9), Pct(steady, 0.5),
           Pct(steady, 0.9), static_cast<long long>(frames_delta_max),
           static_cast<long long>(steady_cycle_count),
           static_cast<long long>(coord_children),
           static_cast<long long>(negotiated),
           static_cast<long long>(hb_frames_sent),
           static_cast<long long>(clock_fanin),
           static_cast<long long>(NetLinkSendsTotal()));
  return out;
}

}  // namespace hvdtpu
