// Standalone exerciser for the chain store, built with ASAN and UBSan by
// mcmcpp_tpu_torch.native.run_sanitized_test().
// Covers: multi-block append, capacity cap, read with burn/thin, compact,
// clear, boundary-crossing appends, negative-free invariants.

#include <cassert>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

extern "C" {
void* mc_chain_create(int64_t, int64_t, int64_t, int64_t);
int64_t mc_chain_append(void*, int64_t, const void*, const void*);
int64_t mc_chain_steps(void*);
int64_t mc_chain_bytes(void*);
int64_t mc_chain_read_count(void*, int64_t, int64_t);
void mc_chain_read(void*, void*, void*, int64_t, int64_t);
void mc_chain_compact(void*, int64_t, int64_t);
void mc_chain_clear(void*);
void mc_chain_destroy(void*);
}

static void fill(std::vector<float>& v, int64_t seed) {
  for (size_t i = 0; i < v.size(); ++i) v[i] = float((seed * 31 + i) % 1000);
}

int main() {
  const int64_t W = 8, P = 3, item = 4;
  const int64_t row = W * (P + 1) * item;

  // 1. capacity cap honored exactly
  {
    void* c = mc_chain_create(W, P, 7 * row, item);
    std::vector<float> pos(5 * W * P), lp(5 * W);
    fill(pos, 1);
    fill(lp, 2);
    assert(mc_chain_append(c, 5, pos.data(), lp.data()) == 5);
    assert(mc_chain_append(c, 5, pos.data(), lp.data()) == 2);
    assert(mc_chain_steps(c) == 7);
    assert(mc_chain_append(c, 1, pos.data(), lp.data()) == 0);
    mc_chain_destroy(c);
  }

  // 2. multi-block round trip (block_steps small via big rows)
  {
    const int64_t W2 = 64, P2 = 1024;  // row ~256KB -> block_steps = 255
    void* c = mc_chain_create(W2, P2, int64_t(4) << 30, item);
    const int64_t S = 600;  // crosses >2 blocks
    std::vector<float> pos(S * W2 * P2), lp(S * W2);
    fill(pos, 3);
    fill(lp, 4);
    assert(mc_chain_append(c, S, pos.data(), lp.data()) == S);
    assert(mc_chain_steps(c) == S);
    std::vector<float> rpos(S * W2 * P2), rlp(S * W2);
    assert(mc_chain_read_count(c, 0, 1) == S);
    mc_chain_read(c, rpos.data(), rlp.data(), 0, 1);
    assert(std::memcmp(pos.data(), rpos.data(), pos.size() * 4) == 0);
    assert(std::memcmp(lp.data(), rlp.data(), lp.size() * 4) == 0);

    // 3. burn+thin read
    const int64_t burn = 100, thin = 7;
    int64_t kept = mc_chain_read_count(c, burn, thin);
    assert(kept == (S - burn + thin - 1) / thin);
    std::vector<float> tpos(kept * W2 * P2), tlp(kept * W2);
    mc_chain_read(c, tpos.data(), tlp.data(), burn, thin);
    for (int64_t k = 0; k < kept; ++k) {
      int64_t src = burn + k * thin;
      assert(std::memcmp(tpos.data() + k * W2 * P2,
                         pos.data() + src * W2 * P2, W2 * P2 * 4) == 0);
    }

    // 4. compact == read-then-rebuild
    mc_chain_compact(c, burn, thin);
    assert(mc_chain_steps(c) == kept);
    std::vector<float> cpos(kept * W2 * P2), clp(kept * W2);
    mc_chain_read(c, cpos.data(), clp.data(), 0, 1);
    assert(std::memcmp(cpos.data(), tpos.data(), cpos.size() * 4) == 0);

    // 5. clear + reuse
    mc_chain_clear(c);
    assert(mc_chain_steps(c) == 0 && mc_chain_bytes(c) == 0);
    assert(mc_chain_append(c, 3, pos.data(), lp.data()) == 3);
    mc_chain_destroy(c);
  }

  // 6. degenerate creates rejected
  assert(mc_chain_create(0, 3, 1000, 4) == nullptr);
  assert(mc_chain_create(8, 0, 1000, 4) == nullptr);

  std::puts("chain_store ASAN tests passed");
  return 0;
}
