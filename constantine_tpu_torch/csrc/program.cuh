// Straight-line programs of Fp operations for a team of threads that share
// one lane: the pairing kernels K11 (miller_loop.cu) and K12 (final_exp.cu).
//
// A one-thread pairing is a chain of ~8,000 dependent 12-limb multiplies.
// Most of them are independent of each other inside a tower product (an
// Fp12 product is 54 Fp products once its Karatsuba sums are known), so the
// lane is given to a team of T threads and its work to a *program*: rounds
// of at most T independent tasks, one per member, with the team's sync
// between rounds. A task reads its operands from the lane's slot file (Fp
// values in shared memory), computes one Fp value and writes it to a slot:
//   LIN   sum of up to 12 slots with small signed coefficients (the tower's
//         Karatsuba pre- and post-additions, xi products, 3v - 2b, ...)
//   HALF  the same sum halved (the doubling step's XY/2 and (B + 3E)/2)
//   MUL   (sum of up to 6 slots) x (sum of up to 6 slots), over fe_mul_eo
//   INV   x^(p-2) by a fixed 4-bit window: one member, the others wait
// Every value is canonical mod p, so any grouping of the same field
// operations gives the same limbs: a program computes the same Fp elements
// as the one-thread formulas it was built from.
//
// The host builds the program once (Builder and compile below, plain C++):
// the tower formulas run over node ids instead of values and record a graph
// (tower.cuh, pairing.cuh); additions fold into the sums of the tasks that
// use them; a list scheduler packs the graph into rounds by each node's
// longest path to the end (a round with a product costs ~16 rounds of sums);
// slots are reused once their last reader's round has passed, so no round
// both reads and writes a slot. The card runs the rounds (the kernels), and
// so does the host with one thread playing every member in turn
// (pairing_host.cpp): the CPU tests check the schedule the card runs.
//
// What bounds it on an H100 (scripts/torch_pairing_teams.py, PERF.md): the
// products cost about the chain floor (a round with products, one
// multiply's latency); the rest is the sums and each round's fixed cost
// (task load, slot loads and stores, the sync). A sum is therefore carry-
// free until one reduction (lin_reduce), and as wide as measured best.
#pragma once

#include <stdint.h>

#include "ec.cuh"

#include <algorithm>
#include <map>
#include <queue>
#include <stdexcept>
#include <vector>

namespace ctt {

constexpr int FPN = 12;
using Fp = Fe<FPN>;
using MdP = Mod<FPN>;

// A host-known exponent: little-endian words and its bit length.
struct FpExp {
  uint32_t w[FPN];
  int nbits;
};

// a / 2 mod p: (a + p*odd(a)) >> 1; a + p < 2^382 needs no extra word.
CTT_HD Fp fp_div2(const Fp& a, const MdP& M) {
  const uint32_t mask = 0u - (a.v[0] & 1u);
  uint32_t t[FPN];
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < FPN; ++i) {
    const uint64_t s = (uint64_t)a.v[i] + (M.p[i] & mask) + c;
    t[i] = (uint32_t)s;
    c = s >> 32;
  }
  Fp r;
#pragma unroll
  for (int i = 0; i < FPN - 1; ++i) r.v[i] = (t[i] >> 1) | (t[i + 1] << 31);
  r.v[FPN - 1] = t[FPN - 1] >> 1;
  return r;
}

// 4-bit window i of e (windows never straddle a word).
CTT_HD int exp_window(const FpExp& e, int i) { return (e.w[i >> 3] >> ((i & 7) * 4)) & 15; }

// x^e for a public e, fixed 4-bit windows over fe_mul_eo: 14 products for
// the table, 4 squarings a window and a product where the window is not 0
// (485 multiplies for p - 2, against 608 bit by bit).
CTT_HD Fp fp_pow_window(const Fp& x, const FpExp& e, const MdP& M) {
  Fp tab[16];
  tab[0] = fe_one<FPN>(M);
  tab[1] = x;
#pragma unroll 1
  for (int k = 2; k < 16; ++k) tab[k] = fe_mul_eo<FPN>(tab[k - 1], x, M);
  const int nw = (e.nbits + 3) / 4;
  Fp acc = tab[exp_window(e, nw - 1)];
#pragma unroll 1
  for (int i = nw - 2; i >= 0; --i) {
#pragma unroll 1
    for (int s = 0; s < 4; ++s) acc = fe_mul_eo<FPN>(acc, acc, M);
    const int w = exp_window(e, i);
    if (w) acc = fe_mul_eo<FPN>(acc, tab[w], M);
  }
  return acc;
}

// -- tasks ---------------------------------------------------------------------

enum : uint8_t { OP_NOP = 0, OP_LIN = 1, OP_HALF = 2, OP_MUL = 3, OP_INV = 4 };
constexpr int TASK_TERMS = 12;  // terms of a task: a sum's, or half for each product operand
constexpr int MUL_TERMS = TASK_TERMS / 2;
constexpr int MAX_COEF = 127;
constexpr int MAX_SLOTS = 1024;

// A task reads terms i < TASK_TERMS: coefficient coef[i] (0 for none) of
// slot slot[i]. LIN: dst = the sum of all terms; HALF: that sum halved;
// MUL: dst = (sum of the first MUL_TERMS) x (sum of the rest); INV: dst =
// (sum of the first MUL_TERMS)^(p-2). A program is rounds x T tasks; task m
// of a round is member m's (OP_NOP where the round has fewer than T).
struct alignas(16) Task {
  uint8_t op, pad;
  uint16_t dst;
  int8_t coef[TASK_TERMS];
  uint16_t slot[TASK_TERMS];
};
constexpr int TASK_VECS = sizeof(Task) / 16;   // 16-byte loads a task

// Slot k of a lane's slot file is words [12k, 12k + 12); the file is
// 16-byte aligned, so a slot is three 16-byte accesses on the card.
CTT_HD Fp slot_load(const uint32_t* s, int k) {
  Fp r;
#if defined(__CUDA_ARCH__)
  const uint4* p = reinterpret_cast<const uint4*>(s + k * FPN);
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    const uint4 v = p[q];
    r.v[4 * q] = v.x;
    r.v[4 * q + 1] = v.y;
    r.v[4 * q + 2] = v.z;
    r.v[4 * q + 3] = v.w;
  }
#else
  for (int l = 0; l < FPN; ++l) r.v[l] = s[k * FPN + l];
#endif
  return r;
}

CTT_HD void slot_store(uint32_t* s, int k, const Fp& a) {
#if defined(__CUDA_ARCH__)
  uint4* p = reinterpret_cast<uint4*>(s + k * FPN);
#pragma unroll
  for (int q = 0; q < 3; ++q)
    p[q] = make_uint4(a.v[4 * q], a.v[4 * q + 1], a.v[4 * q + 2], a.v[4 * q + 3]);
#else
  for (int l = 0; l < FPN; ++l) s[k * FPN + l] = a.v[l];
#endif
}

// -- sums: sum c_i x_i mod p without a carry chain per term ---------------------
//
// A term c x adds c x[l] to 64-bit limb l; a negative one adds |c| ~x[l] (the
// complement of x's 384 bits) and |c| to K, since -x = ~x + 1 - 2^384 and
// 2^384 = R = one mod p. So sum c_i x_i = V mod p for V = the limbs + K +
// K p - K one >= 0 (V < 2^395), and its canonical value is V - q p for
// q = floor(V / p) or one less, then at most one subtraction of p. q comes
// from the top three limbs in double precision, |error| < 2^-37, minus
// 2^-20: floor(V / p) - 1 <= q <= floor(V / p) whatever the rounding, so the
// result is the same on the card and the host. Every term is two
// independent instructions a limb (a xor and a 32x32 -> 64 multiply-add), the
// same for every member; one carry pass a sum.
struct LinAcc {
  uint64_t v[FPN];
  uint32_t k;
};

CTT_HD LinAcc lin_zero() {
  LinAcc a;
#pragma unroll
  for (int l = 0; l < FPN; ++l) a.v[l] = 0;
  a.k = 0;
  return a;
}

CTT_HD void lin_term(LinAcc& a, const Fp& x, int c) {
  const uint32_t mask = c < 0 ? 0xffffffffu : 0u;
  const uint32_t m = (uint32_t)(c < 0 ? -c : c);
#pragma unroll
  for (int l = 0; l < FPN; ++l) a.v[l] += (uint64_t)(x.v[l] ^ mask) * m;
  a.k += mask & m;
}

CTT_HD void lin_merge(LinAcc& a, const LinAcc& b) {
#pragma unroll
  for (int l = 0; l < FPN; ++l) a.v[l] += b.v[l];
  a.k += b.k;
}

// 2^352 / p, for lin_reduce's quotient.
CTT_HD double p_top_inv(const MdP& M) {
  return 1.0 / ((double)M.p[FPN - 1] + (double)M.p[FPN - 2] * 0x1p-32 +
                (double)M.p[FPN - 3] * 0x1p-64);
}

CTT_HD Fp lin_reduce(const LinAcc& a, const MdP& M, double inv_p) {
  int64_t v[FPN];
#pragma unroll
  for (int l = 0; l < FPN; ++l)
    v[l] = (int64_t)(a.v[l] + (uint64_t)a.k * M.p[l] - (uint64_t)a.k * M.one[l]);
  v[0] += a.k;
  const double t = (double)v[FPN - 1] + (double)v[FPN - 2] * 0x1p-32 +
                   (double)v[FPN - 3] * 0x1p-64;
  const double qd = t * inv_p - 0x1p-20;
  const int64_t q = qd > 0 ? (int64_t)qd : 0;
  Fp r, d;
  int64_t carry = 0;
#pragma unroll
  for (int l = 0; l < FPN; ++l) {
    const int64_t w = v[l] - q * (int64_t)M.p[l] + carry;
    r.v[l] = (uint32_t)w;
    carry = w >> 32;
  }
  // r < 2p: subtract p once if it fits
  int64_t borrow = 0;
#pragma unroll
  for (int l = 0; l < FPN; ++l) {
    const int64_t w = (int64_t)r.v[l] - M.p[l] + borrow;
    d.v[l] = (uint32_t)w;
    borrow = w >> 32;
  }
  return fe_sel<FPN>(borrow == 0, d, r);
}

// One member's task of a round. Every member accumulates all terms into
// both halves the same way, unused ones with coefficient 0 (a branch a term
// measured slower: it serialises the terms' loads); only the op's last step
// differs.
CTT_HD void exec_task(const Task& t, uint32_t* s, const MdP& M, const FpExp& inv_exp,
                      double inv_p) {
  if (t.op == OP_NOP) return;
  LinAcc lo = lin_zero(), hi = lin_zero();
#pragma unroll
  for (int i = 0; i < TASK_TERMS; ++i)
    lin_term(i < MUL_TERMS ? lo : hi, slot_load(s, t.slot[i]), t.coef[i]);
  Fp r;
  if (t.op == OP_MUL) {
    r = fe_mul_eo<FPN>(lin_reduce(lo, M, inv_p), lin_reduce(hi, M, inv_p), M);
  } else if (t.op == OP_INV) {
    r = fp_pow_window(lin_reduce(lo, M, inv_p), inv_exp, M);
  } else {
    lin_merge(lo, hi);
    r = lin_reduce(lo, M, inv_p);
    if (t.op == OP_HALF) r = fp_div2(r, M);
  }
  slot_store(s, t.dst, r);
}

// Multiplies of fp_pow_window(., e).
inline int pow_window_muls(const FpExp& e) {
  const int nw = (e.nbits + 3) / 4;
  int n = 14 + 4 * (nw - 1);
  for (int i = 0; i < nw - 1; ++i) n += exp_window(e, i) != 0;
  return n;
}

// -- building a program on the host -------------------------------------------

struct Term {
  int c;  // coefficient
  int n;  // node
};

enum NodeKind : uint8_t { N_ZERO, N_IN, N_LIN, N_HALF, N_MUL, N_INV };

struct Node {
  NodeKind kind;
  int slot;                // N_IN: its fixed slot
  std::vector<Term> a, b;  // N_LIN, N_HALF: a; N_MUL: a * b; N_INV: a
};

// The graph of one program. Node 0 is zero; inputs sit in fixed slots.
// add/sub/neg/scale fold their operands' sums into one sum while it fits a
// task; mul folds operands of up to MUL_TERMS terms into the product task;
// products by zero and by the Montgomery one fold away; a node equal to an
// earlier one (same kind and terms, a product's operands in either order)
// is that node.
class Builder {
 public:
  std::vector<Node> nodes{Node{N_ZERO, -1, {}, {}}};
  int one = -1;

  int zero() const { return 0; }
  int input(int slot) { return push(Node{N_IN, slot, {}, {}}); }
  int input_one(int slot) { return one = input(slot); }

  int add(int x, int y) { return combine({{1, x}, {1, y}}); }
  int sub(int x, int y) { return combine({{1, x}, {-1, y}}); }
  int neg(int x) { return combine({{-1, x}}); }
  int scale(int x, int c) { return combine({{c, x}}); }

  int half(int x) {
    std::vector<Term> t = expand(x, 1);
    if (t.empty()) return 0;
    if (!fits(t, TASK_TERMS)) t = {{1, x}};
    return push(Node{N_HALF, -1, t, {}});
  }

  int mul(int x, int y) {
    if (x == 0 || y == 0) return 0;
    if (x == one) return y;
    if (y == one) return x;
    return push(Node{N_MUL, -1, operand(x), operand(y)});
  }

  int inv(int x) {
    if (x == 0) throw std::logic_error("inverse of zero");
    return push(Node{N_INV, -1, {{1, x}}, {}});
  }

  // A node that holds x in a slot of its own when x is zero (an output).
  int materialize(int x) { return x == 0 ? push(Node{N_LIN, -1, {}, {}}) : x; }

 private:
  std::map<std::vector<int>, int> seen;

  int push(Node n) {
    if (n.kind != N_IN) {
      std::vector<Term> a = n.a, b = n.b;
      auto order = [](std::vector<Term>& t) {
        std::sort(t.begin(), t.end(), [](const Term& x, const Term& y) {
          return x.n != y.n ? x.n < y.n : x.c < y.c;
        });
      };
      order(a);
      order(b);
      auto key_of = [&](const std::vector<Term>& x, const std::vector<Term>& y) {
        std::vector<int> k{(int)n.kind, (int)x.size()};
        for (const Term& t : x) k.insert(k.end(), {t.c, t.n});
        for (const Term& t : y) k.insert(k.end(), {t.c, t.n});
        return k;
      };
      std::vector<int> key = key_of(a, b);
      if (n.kind == N_MUL) key = std::min(key, key_of(b, a));
      auto it = seen.find(key);
      if (it != seen.end()) return it->second;
      seen.emplace(std::move(key), (int)nodes.size());
    }
    nodes.push_back(std::move(n));
    return (int)nodes.size() - 1;
  }

  static bool fits(const std::vector<Term>& t, int max_terms) {
    if ((int)t.size() > max_terms) return false;
    for (const Term& x : t)
      if (x.c > MAX_COEF || x.c < -MAX_COEF) return false;
    return true;
  }

  // c times the terms of n: a sum's own terms, else n itself.
  std::vector<Term> expand(int n, int c) const {
    const Node& x = nodes[n];
    if (x.kind == N_ZERO) return {};
    if (x.kind != N_LIN) return {{c, n}};
    std::vector<Term> t;
    for (const Term& y : x.a) t.push_back({c * y.c, y.n});
    return t;
  }

  static void merge(std::vector<Term>& t, const Term& x) {
    for (Term& y : t)
      if (y.n == x.n) {
        y.c += x.c;
        return;
      }
    t.push_back(x);
  }

  static std::vector<Term> tidy(std::vector<Term> t) {
    t.erase(std::remove_if(t.begin(), t.end(), [](const Term& x) { return x.c == 0; }),
            t.end());
    return t;
  }

  int combine(const std::vector<Term>& parts) {
    std::vector<Term> t;
    for (const Term& p : parts)
      for (const Term& x : expand(p.n, p.c)) merge(t, x);
    t = tidy(t);
    if (!fits(t, TASK_TERMS)) {
      t.clear();
      for (const Term& p : parts)
        if (nodes[p.n].kind != N_ZERO) merge(t, p);
      t = tidy(t);
      if (!fits(t, TASK_TERMS)) throw std::logic_error("a sum does not fit a task");
    }
    if (t.empty()) return 0;
    if (t.size() == 1 && t[0].c == 1) return t[0].n;
    return push(Node{N_LIN, -1, t, {}});
  }

  std::vector<Term> operand(int x) const {
    std::vector<Term> t = expand(x, 1);
    return fits(t, MUL_TERMS) ? t : std::vector<Term>{{1, x}};
  }
};

// A compiled program and what the card's time is made of.
struct Program {
  int T = 1;
  int rounds = 0;
  int slots = 0;
  std::vector<Task> tasks;        // rounds x T
  std::vector<uint16_t> out;      // slot of each output
  int muls = 0, sums = 0;         // product and sum tasks (an INV counts in inv_muls)
  int mul_rounds = 0;             // rounds with a product and no INV
  int inv_muls = 0;               // multiplies of the lone INV chains
};

// Schedule the nodes that the outputs need into rounds of at most T tasks
// and give each a slot. Slots [0, n_fixed) hold the inputs (loaded before
// round 0); a slot is free again in the round after its last reader's.
inline Program compile(Builder& B, std::vector<int> outs, int T, int n_fixed,
                       const FpExp& inv_exp) {
  for (int& o : outs) o = B.materialize(o);
  const std::vector<Node>& nodes = B.nodes;
  const int N = (int)nodes.size();
  const int kInf = 1 << 30;
  auto deps = [&](int n) {
    std::vector<int> d;
    for (const Term& t : nodes[n].a) d.push_back(t.n);
    for (const Term& t : nodes[n].b) d.push_back(t.n);
    std::sort(d.begin(), d.end());
    d.erase(std::unique(d.begin(), d.end()), d.end());
    return d;
  };
  auto scheduled = [&](int n) { return nodes[n].kind != N_IN && nodes[n].kind != N_ZERO; };

  std::vector<char> live(N, 0);
  for (int o : outs) live[o] = 1;
  std::vector<std::vector<int>> users(N);
  for (int n = N - 1; n >= 0; --n) {
    if (!live[n]) continue;
    for (int d : deps(n)) {
      live[d] = 1;
      users[d].push_back(n);
    }
  }

  const int inv_cost = 16 * pow_window_muls(inv_exp);
  std::vector<long> prio(N, 0);
  std::vector<int> pending(N, 0);
  for (int n = N - 1; n >= 0; --n) {
    if (!live[n] || !scheduled(n)) continue;
    const NodeKind k = nodes[n].kind;
    long best = 0;
    for (int u : users[n]) best = std::max(best, prio[u]);
    prio[n] = best + (k == N_MUL ? 16 : k == N_INV ? inv_cost : 1);
    for (int d : deps(n)) pending[n] += scheduled(d);
  }

  // list scheduling: a round whose most urgent task is a product (or the
  // inverse) takes products and sums; otherwise only sums, and the
  // products wait for the next round that multiplies anyway
  auto cmp = [&](int x, int y) { return prio[x] != prio[y] ? prio[x] < prio[y] : x > y; };
  std::priority_queue<int, std::vector<int>, decltype(cmp)> ready(cmp);
  int total = 0;
  for (int n = 0; n < N; ++n)
    if (live[n] && scheduled(n)) {
      ++total;
      if (pending[n] == 0) ready.push(n);
    }
  std::vector<std::vector<int>> rounds;
  std::vector<int> round_of(N, -1);
  Program P;
  P.T = T;
  while (total > 0) {
    if (ready.empty()) throw std::logic_error("schedule: nothing ready");
    const NodeKind top = nodes[ready.top()].kind;
    const bool multiply = top == N_MUL || top == N_INV;
    std::vector<int> pick, later;
    while ((int)pick.size() < T && !ready.empty()) {
      const int n = ready.top();
      ready.pop();
      const NodeKind k = nodes[n].kind;
      if (!multiply && (k == N_MUL || k == N_INV))
        later.push_back(n);
      else
        pick.push_back(n);
    }
    for (int n : later) ready.push(n);
    bool has_mul = false, has_inv = false;
    for (int n : pick) {
      round_of[n] = (int)rounds.size();
      has_mul |= nodes[n].kind == N_MUL;
      has_inv |= nodes[n].kind == N_INV;
      P.muls += nodes[n].kind == N_MUL;
      P.sums += nodes[n].kind == N_LIN || nodes[n].kind == N_HALF;
    }
    if (has_inv) P.inv_muls += pow_window_muls(inv_exp);
    else if (has_mul) ++P.mul_rounds;
    for (int n : pick)
      for (int u : users[n])
        if (--pending[u] == 0) ready.push(u);
    total -= (int)pick.size();
    rounds.push_back(std::move(pick));
  }

  // slots: free from the round after the last reader's; outputs never
  std::vector<int> last(N, -1), slot(N, -1);
  for (int n = 0; n < N; ++n)
    if (live[n])
      for (int u : users[n]) last[n] = std::max(last[n], round_of[u]);
  for (int o : outs) last[o] = kInf;
  const int R = (int)rounds.size();
  std::vector<std::vector<int>> release(R + 1);
  std::priority_queue<int, std::vector<int>, std::greater<int>> freed;
  std::vector<char> fixed_used(n_fixed, 0);
  for (int n = 0; n < N; ++n)
    if (nodes[n].kind == N_IN) {
      slot[n] = nodes[n].slot;
      if (live[n] && last[n] >= 0) {
        fixed_used[slot[n]] = 1;
        if (last[n] < R) release[last[n] + 1].push_back(slot[n]);
      }
    }
  for (int k = 0; k < n_fixed; ++k)
    if (!fixed_used[k]) freed.push(k);
  int next = n_fixed;
  for (int r = 0; r < R; ++r) {
    for (int k : release[r]) freed.push(k);
    for (int n : rounds[r]) {
      if (!freed.empty()) {
        slot[n] = freed.top();
        freed.pop();
      } else {
        slot[n] = next++;
      }
      if (last[n] < R) release[last[n] + 1].push_back(slot[n]);
    }
  }
  if (next > MAX_SLOTS) throw std::logic_error("program needs more than MAX_SLOTS slots");

  P.rounds = R;
  P.slots = next;
  Task nop{};
  P.tasks.assign((size_t)R * T, nop);
  for (int r = 0; r < R; ++r)
    for (size_t m = 0; m < rounds[r].size(); ++m) {
      const Node& x = nodes[rounds[r][m]];
      Task& t = P.tasks[(size_t)r * T + m];
      t.op = x.kind == N_MUL ? OP_MUL : x.kind == N_INV ? OP_INV
             : x.kind == N_HALF ? OP_HALF : OP_LIN;
      t.dst = (uint16_t)slot[rounds[r][m]];
      auto put = [&](const std::vector<Term>& terms, int i) {
        for (const Term& y : terms) {
          t.slot[i] = (uint16_t)slot[y.n];
          t.coef[i++] = (int8_t)y.c;
        }
      };
      put(x.a, 0);
      put(x.b, MUL_TERMS);
    }
  for (int o : outs) P.out.push_back((uint16_t)slot[o]);
  return P;
}

}  // namespace ctt
