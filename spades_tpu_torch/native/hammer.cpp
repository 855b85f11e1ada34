// Union-find over an ordered list of pairs, for the Hamming clustering of
// read error correction (spades_tpu_torch/hammer/clustering.py): the same
// path-halving finds and union by size, in the same order, as its Python
// `DSU.union`, so the parent array comes out identical.
#include <cstdint>
#include <utility>

extern "C" void stbr_dsu_union_pairs(int64_t* parent, int64_t* size, const int64_t* a,
                                     const int64_t* b, int64_t n) {
    for (int64_t i = 0; i < n; ++i) {
        int64_t x = a[i], y = b[i];
        while (parent[x] != x) {
            parent[x] = parent[parent[x]];
            x = parent[x];
        }
        while (parent[y] != y) {
            parent[y] = parent[parent[y]];
            y = parent[y];
        }
        if (x == y) continue;
        if (size[x] < size[y]) std::swap(x, y);
        parent[y] = x;
        size[x] += size[y];
    }
}
