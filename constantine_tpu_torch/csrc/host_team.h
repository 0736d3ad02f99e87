// Host threads standing in for the card's teams, for the g++ builds of the
// team code (ec_host.cpp, pairing_host.cpp): a reusable barrier, and
// ec.cuh's SmTeam with a thread for each member -- the same two sets of T
// product slots, alternating between rounds, and one barrier a round where
// the card's members meet at __syncwarp.
#pragma once

#include <condition_variable>
#include <mutex>
#include <thread>
#include <vector>

#include "ec.cuh"

namespace ctt {

// A barrier for n threads, reusable.
class Barrier {
 public:
  explicit Barrier(int n) : n_(n) {}
  void wait() {
    std::unique_lock<std::mutex> lock(m_);
    const unsigned gen = gen_;
    if (++count_ == n_) {
      count_ = 0;
      ++gen_;
      cv_.notify_all();
    } else {
      cv_.wait(lock, [&] { return gen_ != gen; });
    }
  }

 private:
  std::mutex m_;
  std::condition_variable cv_;
  int n_, count_ = 0;
  unsigned gen_ = 0;
};

template <int N, int kT>
struct ThreadTeam {
  static constexpr int T = kT;
  uint32_t* slots;
  Barrier* bar;
  int rank;
  int par = 0;
  void sync() const { bar->wait(); }
  void put(const Fe<N>& p) {
    uint32_t* s = slots + (par * T + rank) * N;
    for (int l = 0; l < N; ++l) s[l] = p.v[l];
    sync();
  }
  Fe<N> get(int j) const {
    const uint32_t* s = slots + (par * T + j) * N;
    Fe<N> r;
    for (int l = 0; l < N; ++l) r.v[l] = s[l];
    return r;
  }
  void next() { par ^= 1; }
};

// member(tm) for a team of one, or for each of kT threads meeting at a
// barrier.
template <int N, int kT, class Member>
void play_team(Member&& member) {
  if constexpr (kT == 1) {
    Solo<N> tm;
    member(tm);
  } else {
    std::vector<uint32_t> slots(2 * kT * N);
    Barrier bar(kT);
    std::vector<std::thread> threads;
    for (int r = 0; r < kT; ++r)
      threads.emplace_back([&, r] {
        ThreadTeam<N, kT> tm{slots.data(), &bar, r};
        member(tm);
      });
    for (auto& t : threads) t.join();
  }
}

}  // namespace ctt
