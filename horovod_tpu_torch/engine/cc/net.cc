#include "net.h"

#include <arpa/inet.h>
#include <errno.h>
#include <fcntl.h>
#include <netdb.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <poll.h>
#include <string.h>
#include <sys/socket.h>
#include <sys/uio.h>
#include <unistd.h>

#include <algorithm>
#include <atomic>
#include <chrono>
#include <cstdio>
#include <cstdlib>
#include <map>
#include <mutex>
#include <thread>
#include <unordered_map>

namespace hvdtpu {

namespace {

double NowSec() {
  return std::chrono::duration<double>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

void SetCommonOpts(int fd) {
  int one = 1;
  setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  // Large kernel buffers keep the bandwidth-optimal ring streaming instead
  // of stalling on window exhaustion at multi-megabyte segments.
  int buf = 8 * 1024 * 1024;
  setsockopt(fd, SOL_SOCKET, SO_SNDBUF, &buf, sizeof(buf));
  setsockopt(fd, SOL_SOCKET, SO_RCVBUF, &buf, sizeof(buf));
}

bool ResolveAddr(const std::string& host, int port, sockaddr_in* addr) {
  memset(addr, 0, sizeof(*addr));
  addr->sin_family = AF_INET;
  addr->sin_port = htons(static_cast<uint16_t>(port));
  if (inet_pton(AF_INET, host.c_str(), &addr->sin_addr) == 1) return true;
  struct addrinfo hints, *res = nullptr;
  memset(&hints, 0, sizeof(hints));
  hints.ai_family = AF_INET;
  hints.ai_socktype = SOCK_STREAM;
  if (getaddrinfo(host.c_str(), nullptr, &hints, &res) != 0 || !res)
    return false;
  addr->sin_addr = reinterpret_cast<sockaddr_in*>(res->ai_addr)->sin_addr;
  freeaddrinfo(res);
  return true;
}

// ---------------------------------------------------------------------------
// Link-fault injection (HVD_TPU_NET_FAULT_SPEC).  One process-global
// table: the spec is identical on every rank (each applies the clauses
// touching its own links), clauses are parsed once per engine Init, and
// every per-send decision is a mutex-guarded map lookup — zero cost when
// no spec is armed (one relaxed atomic load).
// ---------------------------------------------------------------------------

struct FaultClause {
  bool partition = false;          // partition=G1/G2 (drop across groups)
  int a = -1, b = -1;              // link=A-B endpoints
  std::vector<int> group_a, group_b;
  bool drop = false;
  double delay_ms = 0.0, jitter_ms = 0.0;
  double flaky = 0.0;              // per-send chopped-write probability
  double after_sec = 0.0;          // clause arms this long after Init
  std::string text;                // source clause (typed-error messages)
};

struct FaultFd {
  int peer = -1;
  int clause = -1;   // index into g_fault_clauses; -1 = no clause matches
  uint32_t rng = 1;  // deterministic per-link LCG state
};

std::mutex g_fault_mu;
std::vector<FaultClause> g_fault_clauses;
std::unordered_map<int, FaultFd> g_fault_fds;
// Peer-rank-keyed clause state for the shm seam (rings have no fd);
// lazily resolved, reset by NetFaultInit like the fd registry.
std::unordered_map<int, FaultFd> g_fault_peers;
int g_fault_rank = -1;
uint32_t g_fault_seed = 0;
double g_fault_t0 = 0.0;
std::atomic<bool> g_fault_armed{false};

// ---------------------------------------------------------------------------
// Per-peer link telemetry (net.h NetLink*).  Shares g_fault_mu with the
// fd -> peer registry above so one lock hold covers both the lookup and
// the stat update; keyed by PEER RANK (stats survive fd churn and
// re-init — the StallEvents process-cumulative contract).
// ---------------------------------------------------------------------------

struct LinkStats {
  long long bytes_out = 0, bytes_in = 0;
  long long sends = 0, recvs = 0;
  long long stalls = 0;        // EAGAIN retry events on a send path
  long long short_writes = 0;  // kernel accepted fewer bytes than asked
  long long send_us_sum = 0;
  long long send_us_count = 0;
  long long send_us_buckets[10] = {0};
  long long rtt_last_us = -1;
  double rtt_ewma_us = 0.0;
  long long rtt_samples = 0;
  // Shm-hop counters (docs/metrics.md#links): ring-handoff bytes and
  // the segment-handoff latency histogram, same bucket bounds as the
  // timed-send histogram so one `le` label set serves both.
  long long shm_bytes_out = 0, shm_bytes_in = 0;
  long long shm_handoffs = 0;
  long long shm_us_sum = 0;
  long long shm_us_count = 0;
  long long shm_us_buckets[10] = {0};
};

std::map<int, LinkStats> g_link_stats;  // guarded by g_fault_mu
std::atomic<bool> g_link_enabled{false};

long long LinkNowUs() {
  return std::chrono::duration_cast<std::chrono::microseconds>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

int LinkBucket(long long us) {
  for (int i = 0; i < kNetLinkBuckets - 1; ++i)
    if (us <= kNetLinkBucketUs[i]) return i;
  return kNetLinkBuckets - 1;
}

// One locked update per transport CALL (never per byte): bytes in/out,
// stall/short-write counts, and — when lat_us >= 0 — one timed-send
// histogram sample.  Unregistered fds (pre-registration rendezvous
// traffic, joiner handshakes) fall through untouched.
void LinkRecord(int fd, long long bytes_out, long long bytes_in,
                long long stalls, long long shorts, long long lat_us) {
  std::lock_guard<std::mutex> lk(g_fault_mu);
  auto it = g_fault_fds.find(fd);
  if (it == g_fault_fds.end() || it->second.peer < 0) return;
  LinkStats& s = g_link_stats[it->second.peer];
  s.bytes_out += bytes_out;
  s.bytes_in += bytes_in;
  s.stalls += stalls;
  s.short_writes += shorts;
  if (bytes_in > 0) ++s.recvs;
  if (lat_us >= 0) {
    ++s.sends;
    s.send_us_sum += lat_us;
    ++s.send_us_count;
    ++s.send_us_buckets[LinkBucket(lat_us)];
  }
}

bool ClauseMatches(const FaultClause& c, int me, int peer) {
  if (c.partition) {
    auto in = [](const std::vector<int>& g, int r) {
      for (int x : g) if (x == r) return true;
      return false;
    };
    return (in(c.group_a, me) && in(c.group_b, peer)) ||
           (in(c.group_b, me) && in(c.group_a, peer));
  }
  return (c.a == me && c.b == peer) || (c.b == me && c.a == peer);
}

int ResolveClause(int me, int peer) {
  for (size_t i = 0; i < g_fault_clauses.size(); ++i)
    if (ClauseMatches(g_fault_clauses[i], me, peer))
      return static_cast<int>(i);
  return -1;
}

bool ClauseArmed(const FaultClause& c) {
  return NowSec() - g_fault_t0 >= c.after_sec;
}

double NextRand01(uint32_t* state) {
  *state = *state * 1664525u + 1013904223u;
  return (*state >> 8) / double(1u << 24);
}

bool ParseRankCsv(const std::string& s, std::vector<int>* out) {
  size_t pos = 0;
  while (pos < s.size()) {
    size_t comma = s.find(',', pos);
    std::string tok = s.substr(pos, comma == std::string::npos
                                        ? std::string::npos
                                        : comma - pos);
    char* end = nullptr;
    long r = strtol(tok.c_str(), &end, 10);
    if (tok.empty() || *end != '\0' || r < 0) return false;
    out->push_back(static_cast<int>(r));
    if (comma == std::string::npos) break;
    pos = comma + 1;
  }
  return !out->empty();
}

bool ParseFaultClause(std::string body, FaultClause* c, std::string* err) {
  size_t after = body.rfind("@after=");
  if (after != std::string::npos) {
    char* end = nullptr;
    c->after_sec = strtod(body.c_str() + after + 7, &end);
    if (*end != '\0' || c->after_sec < 0) {
      *err = "bad @after in '" + body + "'";
      return false;
    }
    body = body.substr(0, after);
  }
  if (body.rfind("partition=", 0) == 0) {
    c->partition = true;
    c->drop = true;
    std::string groups = body.substr(10);
    size_t slash = groups.find('/');
    if (slash == std::string::npos ||
        !ParseRankCsv(groups.substr(0, slash), &c->group_a) ||
        !ParseRankCsv(groups.substr(slash + 1), &c->group_b)) {
      *err = "bad partition groups in '" + body + "'";
      return false;
    }
    return true;
  }
  if (body.rfind("link=", 0) != 0) {
    *err = "clause must start with link= or partition=: '" + body + "'";
    return false;
  }
  size_t colon = body.find(':', 5);
  if (colon == std::string::npos) {
    *err = "link clause missing ':action' in '" + body + "'";
    return false;
  }
  std::string pair = body.substr(5, colon - 5);
  size_t dash = pair.find('-');
  char* end = nullptr;
  long a = strtol(pair.c_str(), &end, 10);
  if (dash == std::string::npos || end != pair.c_str() + dash || a < 0) {
    *err = "bad link endpoints in '" + body + "'";
    return false;
  }
  long b = strtol(pair.c_str() + dash + 1, &end, 10);
  if (*end != '\0' || b < 0 || a == b) {
    *err = "bad link endpoints in '" + body + "'";
    return false;
  }
  c->a = static_cast<int>(a);
  c->b = static_cast<int>(b);
  std::string actions = body.substr(colon + 1);
  size_t pos = 0;
  while (pos <= actions.size()) {
    size_t bar = actions.find('|', pos);
    std::string act = actions.substr(
        pos, bar == std::string::npos ? std::string::npos : bar - pos);
    if (act == "drop") {
      c->drop = true;
    } else if (act.rfind("delay=", 0) == 0) {
      c->delay_ms = strtod(act.c_str() + 6, &end);
      if (*end != '\0' || c->delay_ms < 0) {
        *err = "bad delay in '" + body + "'";
        return false;
      }
    } else if (act.rfind("jitter=", 0) == 0) {
      c->jitter_ms = strtod(act.c_str() + 7, &end);
      if (*end != '\0' || c->jitter_ms < 0) {
        *err = "bad jitter in '" + body + "'";
        return false;
      }
    } else if (act.rfind("flaky=", 0) == 0) {
      c->flaky = strtod(act.c_str() + 6, &end);
      if (*end != '\0' || c->flaky < 0 || c->flaky > 1) {
        *err = "bad flaky probability in '" + body + "'";
        return false;
      }
    } else {
      *err = "unknown link action '" + act + "' in '" + body + "'";
      return false;
    }
    if (bar == std::string::npos) break;
    pos = bar + 1;
  }
  if (!c->drop && c->delay_ms == 0 && c->flaky == 0) {
    *err = "link clause with no effect in '" + body + "'";
    return false;
  }
  return true;
}

}  // namespace

void NetFaultArmClock() {
  std::lock_guard<std::mutex> lk(g_fault_mu);
  g_fault_t0 = NowSec();
}

bool NetFaultInit(const std::string& spec, int my_rank, std::string* err) {
  std::lock_guard<std::mutex> lk(g_fault_mu);
  g_fault_clauses.clear();
  g_fault_rank = my_rank;
  g_fault_t0 = NowSec();
  g_fault_seed = 2166136261u;
  for (char ch : spec) g_fault_seed = (g_fault_seed ^ (uint8_t)ch) * 16777619u;
  size_t pos = 0;
  while (pos < spec.size()) {
    size_t semi = spec.find(';', pos);
    std::string body = spec.substr(
        pos, semi == std::string::npos ? std::string::npos : semi - pos);
    while (!body.empty() && body.front() == ' ') body.erase(body.begin());
    while (!body.empty() && body.back() == ' ') body.pop_back();
    if (!body.empty()) {
      FaultClause c;
      if (!ParseFaultClause(body, &c, err)) {
        g_fault_clauses.clear();
        g_fault_armed.store(false);
        return false;
      }
      c.text = body;  // full clause incl. @after, for typed messages
      g_fault_clauses.push_back(std::move(c));
    }
    if (semi == std::string::npos) break;
    pos = semi + 1;
  }
  // Re-resolve fds registered before a re-init against the fresh table.
  for (auto& kv : g_fault_fds)
    kv.second.clause = ResolveClause(g_fault_rank, kv.second.peer);
  g_fault_peers.clear();
  g_fault_armed.store(!g_fault_clauses.empty());
  return true;
}

bool NetFaultActive() {
  return g_fault_armed.load(std::memory_order_relaxed);
}

void NetFaultRegister(int fd, int peer_rank) {
  if (fd < 0) return;
  std::lock_guard<std::mutex> lk(g_fault_mu);
  FaultFd f;
  f.peer = peer_rank;
  f.clause = ResolveClause(g_fault_rank, peer_rank);
  // Seed from (spec, both endpoints) only — NOT the fd number — so a
  // rerun draws the identical chop/jitter sequence per link.
  int lo = std::min(g_fault_rank, peer_rank);
  int hi = std::max(g_fault_rank, peer_rank);
  f.rng = g_fault_seed ^ (static_cast<uint32_t>(lo) * 2654435761u) ^
          (static_cast<uint32_t>(hi) * 40503u) ^ 1u;
  g_fault_fds[fd] = f;
}

void NetFaultForget(int fd) {
  // Erase even when disarmed: a stale entry on a recycled fd number would
  // misattribute faults if a later NetFaultInit re-arms the table.
  if (fd < 0) return;
  std::lock_guard<std::mutex> lk(g_fault_mu);
  g_fault_fds.erase(fd);
}

bool NetFaultDrops(int fd) {
  if (!NetFaultActive()) return false;
  std::lock_guard<std::mutex> lk(g_fault_mu);
  auto it = g_fault_fds.find(fd);
  if (it == g_fault_fds.end() || it->second.clause < 0) return false;
  const FaultClause& c = g_fault_clauses[it->second.clause];
  return c.drop && ClauseArmed(c);
}

void NetFaultDelay(int fd) {
  if (!NetFaultActive()) return;
  double sleep_ms = 0.0;
  {
    std::lock_guard<std::mutex> lk(g_fault_mu);
    auto it = g_fault_fds.find(fd);
    if (it == g_fault_fds.end() || it->second.clause < 0) return;
    const FaultClause& c = g_fault_clauses[it->second.clause];
    if (c.delay_ms <= 0 || !ClauseArmed(c)) return;
    sleep_ms = c.delay_ms + c.jitter_ms * NextRand01(&it->second.rng);
  }
  std::this_thread::sleep_for(
      std::chrono::duration<double, std::milli>(sleep_ms));
}

size_t NetFaultChop(int fd) {
  if (!NetFaultActive()) return 0;
  size_t chop = 0;
  {
    std::lock_guard<std::mutex> lk(g_fault_mu);
    auto it = g_fault_fds.find(fd);
    if (it == g_fault_fds.end() || it->second.clause < 0) return 0;
    const FaultClause& c = g_fault_clauses[it->second.clause];
    if (c.flaky <= 0 || !ClauseArmed(c)) return 0;
    if (NextRand01(&it->second.rng) >= c.flaky) return 0;
    chop = 1 + static_cast<size_t>(NextRand01(&it->second.rng) * 511);
  }
  // The "flaky" stall: long enough to exercise the partial-write retry
  // paths, short enough that training completes (degradation, not fault).
  std::this_thread::sleep_for(std::chrono::microseconds(200));
  return chop;
}

int NetFaultQueryLink(int rank_a, int rank_b, std::string* text) {
  if (!NetFaultActive()) return 0;
  std::lock_guard<std::mutex> lk(g_fault_mu);
  int verdict = 0;
  for (const FaultClause& c : g_fault_clauses) {
    if (!ClauseMatches(c, rank_a, rank_b)) continue;
    // Arming time is irrelevant here: an @after clause that will fire
    // mid-run must shape the transport choice made at init.
    const int v = (c.drop || c.flaky > 0) ? 2 : 1;
    if (v > verdict) {
      verdict = v;
      if (text != nullptr) *text = c.text;
    }
  }
  return verdict;
}

void NetFaultDelayPeer(int peer_rank) {
  if (!NetFaultActive() || peer_rank < 0) return;
  double sleep_ms = 0.0;
  {
    std::lock_guard<std::mutex> lk(g_fault_mu);
    auto it = g_fault_peers.find(peer_rank);
    if (it == g_fault_peers.end()) {
      FaultFd f;
      f.peer = peer_rank;
      f.clause = ResolveClause(g_fault_rank, peer_rank);
      const int lo = std::min(g_fault_rank, peer_rank);
      const int hi = std::max(g_fault_rank, peer_rank);
      // Distinct stream from the fd-keyed registry (^2u vs ^1u) so the
      // shm jitter draw order never aliases a TCP lane's.
      f.rng = g_fault_seed ^ (static_cast<uint32_t>(lo) * 2654435761u) ^
              (static_cast<uint32_t>(hi) * 40503u) ^ 2u;
      it = g_fault_peers.emplace(peer_rank, f).first;
    }
    if (it->second.clause < 0) return;
    const FaultClause& c = g_fault_clauses[it->second.clause];
    if (c.delay_ms <= 0 || !ClauseArmed(c)) return;
    sleep_ms = c.delay_ms + c.jitter_ms * NextRand01(&it->second.rng);
  }
  std::this_thread::sleep_for(
      std::chrono::duration<double, std::milli>(sleep_ms));
}

bool ParseEndpoint(const std::string& ep, std::string* host, int* port) {
  size_t colon = ep.rfind(':');
  if (colon == std::string::npos || colon == 0 || colon + 1 >= ep.size())
    return false;
  *host = ep.substr(0, colon);
  char* end = nullptr;
  long p = strtol(ep.c_str() + colon + 1, &end, 10);
  if (*end != '\0' || p <= 0 || p > 65535) return false;
  *port = static_cast<int>(p);
  return true;
}

int Listen(const std::string& host, int port, std::string* err) {
  sockaddr_in addr;
  if (!ResolveAddr(host, port, &addr)) {
    *err = "cannot resolve " + host;
    return -1;
  }
  int fd = socket(AF_INET, SOCK_STREAM, 0);
  if (fd < 0) {
    *err = strerror(errno);
    return -1;
  }
  int one = 1;
  setsockopt(fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  // Backlog sized for pod-scale rendezvous: at init every rank connects
  // to the rank-0 coordinator at once, and with the old backlog of 64 a
  // few-hundred-rank job hit accept-queue overflow — syncookies let the
  // client think it connected, then the server's unanswered final-ACK
  // retries RST it mid-handshake ("topology agreement exchange failed").
  // The kernel clamps to net.core.somaxconn.
  if (bind(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) != 0 ||
      listen(fd, 4096) != 0) {
    *err = std::string("bind/listen ") + host + ":" + std::to_string(port) +
           ": " + strerror(errno);
    close(fd);
    return -1;
  }
  return fd;
}

int AcceptOne(int listen_fd, double timeout_sec, std::string* err) {
  struct pollfd p = {listen_fd, POLLIN, 0};
  int r = poll(&p, 1, static_cast<int>(timeout_sec * 1000));
  if (r <= 0) {
    *err = r == 0 ? "accept timeout" : strerror(errno);
    return -1;
  }
  int fd = accept(listen_fd, nullptr, nullptr);
  if (fd < 0) {
    *err = strerror(errno);
    return -1;
  }
  SetCommonOpts(fd);
  return fd;
}

int ConnectRetry(const std::string& host, int port, double timeout_sec,
                 std::string* err) {
  sockaddr_in addr;
  if (!ResolveAddr(host, port, &addr)) {
    *err = "cannot resolve " + host;
    return -1;
  }
  double deadline = NowSec() + timeout_sec;
  // Exponential backoff with jitter: 20ms doubling to a ~1s cap.  N ranks
  // hammering one late coordinator in 20ms lockstep both wastes CPU and
  // synchronizes the SYN bursts; the jitter (+/-25%, cheap LCG seeded per
  // call) de-correlates them.
  double delay_ms = 20.0;
  const double kMaxDelayMs = 1000.0;
  uint32_t jitter_state =
      static_cast<uint32_t>(NowSec() * 1e6) ^ (static_cast<uint32_t>(port) << 16);
  int attempts = 0;
  int last_errno = 0;
  while (true) {
    int fd = socket(AF_INET, SOCK_STREAM, 0);
    if (fd < 0) {
      *err = strerror(errno);
      return -1;
    }
    ++attempts;
    if (connect(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) == 0) {
      // TCP self-connect guard: when the target port sits in the
      // ephemeral range and the peer is not listening YET, the kernel
      // can pick the destination port as this socket's source port and
      // "succeed" via simultaneous open — the socket is connected to
      // ITSELF, the rendezvous hello echoes back, and the real peer
      // never hears from us (seen as one-in-N init failures of the
      // simulated-scale harness's loopback rendezvous storm).  Detect
      // the loop and retry; the self-connection's teardown frees the
      // port for the real listener.
      sockaddr_in self{}, peer{};
      socklen_t slen = sizeof(self), plen = sizeof(peer);
      if (getsockname(fd, reinterpret_cast<sockaddr*>(&self), &slen) == 0 &&
          getpeername(fd, reinterpret_cast<sockaddr*>(&peer), &plen) == 0 &&
          self.sin_port == peer.sin_port &&
          self.sin_addr.s_addr == peer.sin_addr.s_addr) {
        last_errno = ECONNREFUSED;
        close(fd);
      } else {
        SetCommonOpts(fd);
        return fd;
      }
    } else {
      last_errno = errno;
      close(fd);
    }
    if (NowSec() >= deadline) {
      *err = std::string("connect ") + host + ":" + std::to_string(port) +
             " timed out after " + std::to_string(attempts) +
             " attempts: " + strerror(last_errno);
      return -1;
    }
    jitter_state = jitter_state * 1664525u + 1013904223u;
    double jitter = 0.75 + 0.5 * (jitter_state >> 8) / double(1u << 24);
    double sleep_ms = delay_ms * jitter;
    double remaining_ms = (deadline - NowSec()) * 1000.0;
    if (sleep_ms > remaining_ms) sleep_ms = remaining_ms > 0 ? remaining_ms : 0;
    std::this_thread::sleep_for(
        std::chrono::duration<double, std::milli>(sleep_ms));
    delay_ms = std::min(delay_ms * 2.0, kMaxDelayMs);
  }
}

bool SendAll(int fd, const void* buf, size_t len) {
  size_t first_cap = 0;
  // The latency clock starts BEFORE the fault hooks: an injected
  // `link=A-B:delay=MS` sleep is part of what this link costs, and the
  // telemetry must see it the way a real slow route would look.
  const bool track = NetLinkEnabled();
  const long long t0 = track ? LinkNowUs() : 0;
  long long stalls = 0, shorts = 0;
  const size_t total = len;
  if (NetFaultActive()) {
    // A dropped link swallows the bytes but reports success: the sender
    // keeps running and the receiver sees pure silence (never EOF) — the
    // only observable is the heartbeat detector, exactly like a real
    // blackholed route.
    if (NetFaultDrops(fd)) return true;
    NetFaultDelay(fd);
    // Chop only the FIRST write of the call: one RNG draw per message,
    // which is what "per send" means in the spec grammar, and the retry
    // loop below transparently finishes the remainder.
    first_cap = NetFaultChop(fd);
  }
  const char* p = static_cast<const char*>(buf);
  while (len > 0) {
    size_t want = len;
    if (first_cap > 0 && first_cap < want) want = first_cap;
    first_cap = 0;
    ssize_t n = send(fd, p, want, MSG_NOSIGNAL);
    if (n <= 0) {
      if (n < 0 && (errno == EINTR || errno == EAGAIN)) {
        if (n < 0 && errno == EAGAIN) ++stalls;
        continue;
      }
      return false;
    }
    if (static_cast<size_t>(n) < want) ++shorts;
    p += n;
    len -= static_cast<size_t>(n);
  }
  if (track)
    LinkRecord(fd, static_cast<long long>(total), 0, stalls, shorts,
               LinkNowUs() - t0);
  return true;
}

bool SendVec(int fd, const struct iovec* iov_in, int iovcnt) {
  size_t total = 0;
  for (int i = 0; i < iovcnt; ++i) total += iov_in[i].iov_len;
  if (total == 0) return true;
  const bool track = NetLinkEnabled();
  const long long t0 = track ? LinkNowUs() : 0;
  long long stalls = 0, shorts = 0;
  size_t first_cap = 0;
  if (NetFaultActive()) {
    if (NetFaultDrops(fd)) return true;  // blackhole, like SendAll
    NetFaultDelay(fd);
    first_cap = NetFaultChop(fd);
  }
  std::vector<struct iovec> iov(iov_in, iov_in + iovcnt);
  size_t idx = 0, left = total;
  while (left > 0) {
    while (idx < iov.size() && iov[idx].iov_len == 0) ++idx;
    ssize_t n;
    size_t asked;
    if (first_cap > 0) {
      // Chopped first write: emulate the flaky clause on the leading
      // iovec only; the loop below finishes the remainder gathered.
      asked = std::min(first_cap, iov[idx].iov_len);
      first_cap = 0;
      n = send(fd, iov[idx].iov_base, asked, MSG_NOSIGNAL);
    } else {
      asked = left;
      struct msghdr msg;
      memset(&msg, 0, sizeof(msg));
      msg.msg_iov = &iov[idx];
      msg.msg_iovlen = iov.size() - idx;
      n = sendmsg(fd, &msg, MSG_NOSIGNAL);
    }
    if (n <= 0) {
      if (n < 0 && (errno == EINTR || errno == EAGAIN)) {
        if (errno == EAGAIN) ++stalls;
        continue;
      }
      return false;
    }
    if (static_cast<size_t>(n) < asked) ++shorts;
    left -= static_cast<size_t>(n);
    size_t adv = static_cast<size_t>(n);
    while (adv > 0 && idx < iov.size()) {
      if (adv >= iov[idx].iov_len) {
        adv -= iov[idx].iov_len;
        iov[idx].iov_len = 0;
        ++idx;
      } else {
        iov[idx].iov_base = static_cast<char*>(iov[idx].iov_base) + adv;
        iov[idx].iov_len -= adv;
        adv = 0;
      }
    }
  }
  if (track)
    LinkRecord(fd, static_cast<long long>(total), 0, stalls, shorts,
               LinkNowUs() - t0);
  return true;
}

bool RecvAll(int fd, void* buf, size_t len) {
  const size_t total = len;
  char* p = static_cast<char*>(buf);
  while (len > 0) {
    ssize_t n = recv(fd, p, len, 0);
    if (n <= 0) {
      if (n < 0 && (errno == EINTR || errno == EAGAIN)) continue;
      return false;
    }
    p += n;
    len -= static_cast<size_t>(n);
  }
  if (NetLinkEnabled())
    LinkRecord(fd, 0, static_cast<long long>(total), 0, 0, -1);
  return true;
}

bool PeerClosed(int fd) {
  if (fd < 0) return true;
  char probe;
  ssize_t r = recv(fd, &probe, 1, MSG_PEEK | MSG_DONTWAIT);
  if (r == 0) return true;                                // orderly EOF
  if (r < 0 && (errno == EAGAIN || errno == EWOULDBLOCK ||
                errno == EINTR))
    return false;                                         // alive, just idle
  return r < 0;                                           // hard error
}

bool WaitReadable(int fd, double timeout_sec) {
  double deadline = NowSec() + timeout_sec;
  while (true) {
    double remaining = deadline - NowSec();
    if (remaining < 0) remaining = 0;
    struct pollfd p = {fd, POLLIN, 0};
    int r = poll(&p, 1, static_cast<int>(remaining * 1000));
    if (r > 0) return true;  // readable, error, or hup: let recv surface it
    if (r == 0) return false;
    if (errno != EINTR) return true;  // unexpected: defer to the recv path
  }
}

bool SendFrame(int fd, const std::vector<uint8_t>& payload) {
  uint32_t len = static_cast<uint32_t>(payload.size());
  uint8_t hdr[4] = {static_cast<uint8_t>(len), static_cast<uint8_t>(len >> 8),
                    static_cast<uint8_t>(len >> 16),
                    static_cast<uint8_t>(len >> 24)};
  // One gathered sendmsg instead of two sends: the 4-byte header and the
  // payload leave straight from their own buffers in a single syscall —
  // no stage copy and no header-only segment on the wire.
  struct iovec iov[2];
  iov[0].iov_base = hdr;
  iov[0].iov_len = sizeof(hdr);
  iov[1].iov_base = const_cast<uint8_t*>(payload.data());
  iov[1].iov_len = payload.size();
  return SendVec(fd, iov, payload.empty() ? 1 : 2);
}

bool RecvFrame(int fd, std::vector<uint8_t>* payload) {
  uint8_t hdr[4];
  if (!RecvAll(fd, hdr, 4)) return false;
  uint32_t len = static_cast<uint32_t>(hdr[0]) |
                 (static_cast<uint32_t>(hdr[1]) << 8) |
                 (static_cast<uint32_t>(hdr[2]) << 16) |
                 (static_cast<uint32_t>(hdr[3]) << 24);
  payload->resize(len);
  return len == 0 || RecvAll(fd, payload->data(), len);
}

bool RecvAvailable(int fd, std::vector<uint8_t>* buf) {
  uint8_t tmp[512];
  while (true) {
    ssize_t n = recv(fd, tmp, sizeof(tmp), MSG_DONTWAIT);
    if (n > 0) {
      buf->insert(buf->end(), tmp, tmp + n);
      continue;
    }
    if (n == 0) return false;  // EOF
    if (errno == EINTR) continue;
    if (errno == EAGAIN || errno == EWOULDBLOCK) return true;
    return false;
  }
}

bool Exchange(int send_fd, const void* sbuf, size_t slen, int recv_fd,
              void* rbuf, size_t rlen) {
  const char* sp = static_cast<const char*>(sbuf);
  char* rp = static_cast<char*>(rbuf);
  size_t sent = 0, recvd = 0;
  long long stalls = 0, shorts = 0;
  bool flaky_send = false;
  if (NetFaultActive()) {
    if (NetFaultDrops(send_fd)) sent = slen;  // blackhole the send leg
    if (sent < slen) {
      NetFaultDelay(send_fd);
      flaky_send = true;  // consult the chop table per send iteration
    }
  }
  // Same fd for both directions is fine: poll events are independent.
  while (sent < slen || recvd < rlen) {
    struct pollfd fds[2];
    int n = 0;
    int si = -1, ri = -1;
    if (sent < slen) {
      fds[n] = {send_fd, POLLOUT, 0};
      si = n++;
    }
    if (recvd < rlen) {
      fds[n] = {recv_fd, POLLIN, 0};
      ri = n++;
    }
    int r = poll(fds, static_cast<nfds_t>(n), 30000);
    if (r < 0) {
      if (errno == EINTR) continue;
      return false;
    }
    if (r == 0) return false;  // 30s of total silence: peer is gone
    if (si >= 0 && (fds[si].revents & (POLLOUT | POLLERR | POLLHUP))) {
      // MSG_DONTWAIT: the fds are blocking sockets; without it this send
      // would block until the whole remaining segment is buffered, stalling
      // the recv leg and deadlocking the ring when segments exceed kernel
      // socket buffering (all ranks sending, none draining).
      size_t want = slen - sent;
      if (flaky_send) {
        size_t cap = NetFaultChop(send_fd);
        if (cap > 0 && cap < want) want = cap;
      }
      ssize_t w = send(send_fd, sp + sent, want,
                       MSG_NOSIGNAL | MSG_DONTWAIT);
      if (w < 0 && errno != EINTR && errno != EAGAIN) return false;
      if (w < 0 && errno == EAGAIN) ++stalls;
      if (w > 0) {
        if (static_cast<size_t>(w) < want) ++shorts;
        sent += static_cast<size_t>(w);
      }
    }
    if (ri >= 0 && (fds[ri].revents & (POLLIN | POLLERR | POLLHUP))) {
      ssize_t g = recv(recv_fd, rp + recvd, rlen - recvd, 0);
      if (g == 0) return false;
      if (g < 0 && errno != EINTR && errno != EAGAIN) return false;
      if (g > 0) recvd += static_cast<size_t>(g);
    }
  }
  // Bytes and stall counts only — the poll-multiplexed legs overlap, so a
  // wall-clock span here would measure the slower DIRECTION, not this
  // link's send cost (the timed samples come from SendAll callers).
  if (NetLinkEnabled()) {
    if (slen > 0)
      LinkRecord(send_fd, static_cast<long long>(slen), 0, stalls, shorts,
                 -1);
    if (rlen > 0) LinkRecord(recv_fd, 0, static_cast<long long>(rlen), 0, 0, -1);
  }
  return true;
}

bool ExchangeBi(int right_fd, const void* send_r, size_t send_r_len,
                void* recv_r, size_t recv_r_len, int left_fd,
                const void* send_l, size_t send_l_len, void* recv_l,
                size_t recv_l_len) {
  // Four independent legs over the two full-duplex neighbour sockets:
  // stream A flows rightward (send on right_fd, arrive on left_fd as
  // recv_l), stream B flows leftward (send on left_fd, arrive on right_fd
  // as recv_r).  One poll loop drives all four so both directions of both
  // links stay busy simultaneously — the bandwidth-doubling property of a
  // bidirectional ring.
  struct Leg {
    int fd;
    const char* sp = nullptr;
    char* rp = nullptr;
    size_t len, done = 0;
    long long stalls = 0, shorts = 0;  // send legs only
  };
  Leg sr{right_fd, static_cast<const char*>(send_r), nullptr, send_r_len};
  Leg sl{left_fd, static_cast<const char*>(send_l), nullptr, send_l_len};
  Leg rr{right_fd, nullptr, static_cast<char*>(recv_r), recv_r_len};
  Leg rl{left_fd, nullptr, static_cast<char*>(recv_l), recv_l_len};
  bool flaky = false;
  if (NetFaultActive()) {
    if (NetFaultDrops(right_fd)) sr.done = sr.len;  // blackholed rightward
    if (NetFaultDrops(left_fd)) sl.done = sl.len;   // blackholed leftward
    if (sr.done < sr.len) NetFaultDelay(right_fd);
    if (sl.done < sl.len) NetFaultDelay(left_fd);
    flaky = true;
  }
  auto pending = [](const Leg& l) { return l.done < l.len; };
  while (pending(sr) || pending(sl) || pending(rr) || pending(rl)) {
    struct pollfd fds[2];
    fds[0] = {right_fd, 0, 0};
    fds[1] = {left_fd, 0, 0};
    if (pending(sr)) fds[0].events |= POLLOUT;
    if (pending(rr)) fds[0].events |= POLLIN;
    if (pending(sl)) fds[1].events |= POLLOUT;
    if (pending(rl)) fds[1].events |= POLLIN;
    int r = poll(fds, 2, 30000);
    if (r < 0) {
      if (errno == EINTR) continue;
      return false;
    }
    if (r == 0) return false;  // 30s of total silence: peer is gone
    auto drive_send = [flaky](Leg& l, short revents) -> bool {
      if (!(l.done < l.len) ||
          !(revents & (POLLOUT | POLLERR | POLLHUP)))
        return true;
      size_t want = l.len - l.done;
      if (flaky) {
        size_t cap = NetFaultChop(l.fd);
        if (cap > 0 && cap < want) want = cap;
      }
      ssize_t w = send(l.fd, l.sp + l.done, want,
                       MSG_NOSIGNAL | MSG_DONTWAIT);
      if (w < 0 && errno != EINTR && errno != EAGAIN) return false;
      if (w < 0 && errno == EAGAIN) ++l.stalls;
      if (w > 0) {
        if (static_cast<size_t>(w) < want) ++l.shorts;
        l.done += static_cast<size_t>(w);
      }
      return true;
    };
    auto drive_recv = [](Leg& l, short revents) -> bool {
      if (!(l.done < l.len) || !(revents & (POLLIN | POLLERR | POLLHUP)))
        return true;
      ssize_t g = recv(l.fd, l.rp + l.done, l.len - l.done, MSG_DONTWAIT);
      if (g == 0) return false;
      if (g < 0 && errno != EINTR && errno != EAGAIN) return false;
      if (g > 0) l.done += static_cast<size_t>(g);
      return true;
    };
    if (!drive_send(sr, fds[0].revents) || !drive_recv(rr, fds[0].revents) ||
        !drive_send(sl, fds[1].revents) || !drive_recv(rl, fds[1].revents))
      return false;
  }
  // One folded update per fd (out + in together; no latency sample — the
  // four legs overlap, see Exchange).
  if (NetLinkEnabled()) {
    LinkRecord(right_fd, static_cast<long long>(sr.len),
               static_cast<long long>(rr.len), sr.stalls, sr.shorts, -1);
    LinkRecord(left_fd, static_cast<long long>(sl.len),
               static_cast<long long>(rl.len), sl.stalls, sl.shorts, -1);
  }
  return true;
}

void CloseFd(int fd) {
  if (fd < 0) return;
  NetFaultForget(fd);
  close(fd);
}

void ShutdownFd(int fd) {
  if (fd >= 0) shutdown(fd, SHUT_RDWR);
}

// Bucket bounds chosen for a TCP control/data plane: sub-100µs loopback
// sends up through multi-ms injected (or real DCN) delays; the last
// bucket is +inf.
const long long kNetLinkBucketUs[] = {50,   100,  250,   500,  1000,
                                      2500, 5000, 10000, 50000};
const int kNetLinkBuckets = 10;
static_assert(sizeof(kNetLinkBucketUs) / sizeof(kNetLinkBucketUs[0]) ==
                  kNetLinkBuckets - 1,
              "bucket bounds must be kNetLinkBuckets - 1 entries");

void NetLinkInit(bool enabled) {
  g_link_enabled.store(enabled, std::memory_order_relaxed);
}

bool NetLinkEnabled() {
  return g_link_enabled.load(std::memory_order_relaxed);
}

void NetLinkRecordShm(int peer_rank, long long bytes_out, long long bytes_in,
                      long long handoff_us) {
  if (peer_rank < 0 || !NetLinkEnabled()) return;
  std::lock_guard<std::mutex> lk(g_fault_mu);
  LinkStats& s = g_link_stats[peer_rank];
  s.shm_bytes_out += bytes_out;
  s.shm_bytes_in += bytes_in;
  if (bytes_out > 0) ++s.shm_handoffs;
  if (handoff_us >= 0) {
    s.shm_us_sum += handoff_us;
    ++s.shm_us_count;
    ++s.shm_us_buckets[LinkBucket(handoff_us)];
  }
}

void NetLinkRecordRtt(int peer_rank, long long rtt_us) {
  if (peer_rank < 0 || rtt_us < 0 || !NetLinkEnabled()) return;
  std::lock_guard<std::mutex> lk(g_fault_mu);
  LinkStats& s = g_link_stats[peer_rank];
  s.rtt_last_us = rtt_us;
  ++s.rtt_samples;
  // EWMA (alpha 0.2): smooth enough to ride out scheduler jitter, fresh
  // enough that a developing slow link moves it within a few beats.
  s.rtt_ewma_us = s.rtt_samples == 1
                      ? static_cast<double>(rtt_us)
                      : s.rtt_ewma_us + 0.2 * (rtt_us - s.rtt_ewma_us);
}

long long NetLinkSendsTotal() {
  std::lock_guard<std::mutex> lk(g_fault_mu);
  long long total = 0;
  for (const auto& kv : g_link_stats) total += kv.second.sends;
  return total;
}

std::vector<NetLinkLatencyTotal> NetLinkLatencyTotals() {
  std::lock_guard<std::mutex> lk(g_fault_mu);
  std::vector<NetLinkLatencyTotal> out;
  out.reserve(g_link_stats.size());
  for (const auto& kv : g_link_stats)
    out.push_back({kv.first, kv.second.send_us_sum, kv.second.send_us_count,
                   kv.second.rtt_last_us});
  return out;
}

std::string NetLinkInfo() {
  std::lock_guard<std::mutex> lk(g_fault_mu);
  std::string out = NetLinkEnabled() ? "1|" : "0|";
  bool first = true;
  for (const auto& kv : g_link_stats) {
    const LinkStats& s = kv.second;
    if (!first) out += ';';
    first = false;
    out += std::to_string(kv.first) + ":" + std::to_string(s.bytes_out) +
           ":" + std::to_string(s.bytes_in) + ":" + std::to_string(s.sends) +
           ":" + std::to_string(s.recvs) + ":" + std::to_string(s.stalls) +
           ":" + std::to_string(s.short_writes) + ":" +
           std::to_string(s.send_us_sum) + ":" +
           std::to_string(s.send_us_count) + ":";
    for (int i = 0; i < kNetLinkBuckets; ++i) {
      if (i) out += ',';
      out += std::to_string(s.send_us_buckets[i]);
    }
    out += ":" + std::to_string(s.rtt_last_us) + ":" +
           std::to_string(static_cast<long long>(s.rtt_ewma_us + 0.5)) +
           ":" + std::to_string(s.rtt_samples);
    out += ":" + std::to_string(s.shm_bytes_out) + ":" +
           std::to_string(s.shm_bytes_in) + ":" +
           std::to_string(s.shm_handoffs) + ":" +
           std::to_string(s.shm_us_sum) + ":" +
           std::to_string(s.shm_us_count) + ":";
    for (int i = 0; i < kNetLinkBuckets; ++i) {
      if (i) out += ',';
      out += std::to_string(s.shm_us_buckets[i]);
    }
    // The data-plane label: ring handoffs mean this peer's collective
    // hops ride shm (the TCP bytes that remain are rendezvous/heartbeat
    // control traffic, which always stays on the socket).
    out += std::string(":") +
           (s.shm_bytes_out + s.shm_bytes_in > 0 ? "shm" : "tcp");
  }
  return out;
}

}  // namespace hvdtpu
