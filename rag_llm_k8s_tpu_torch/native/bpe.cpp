// Native BPE merge loop, the port's copy of rag_llm_k8s_tpu/native/bpe.cpp:
// the C++ hot path in place of HF's Rust `tokenizers` crate (which the
// reference uses via AutoTokenizer, its llm/rag.py:25).
//
// Scope: the per-word ranked merge loop — the O(n·m) inner loop that
// dominates encode time. Pre-tokenization (regex) and byte remapping stay in
// Python, which calls in with byte-remapped UTF-8 "words" and gets token ids
// back. Exposed as a C ABI for ctypes.
//
// Build (native/build.py does this at first use):
//   g++ -O2 -std=c++17 -shared -fPIC -o libbpe.so bpe.cpp

#include <cstdint>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct PairHash {
    size_t operator()(const std::pair<std::string, std::string>& p) const {
        std::hash<std::string> h;
        return h(p.first) * 1000003u ^ h(p.second);
    }
};

struct Bpe {
    std::unordered_map<std::string, int32_t> vocab;
    std::unordered_map<std::pair<std::string, std::string>, int32_t, PairHash> ranks;
    // per-handle word cache: the same pre-tokens recur constantly in prose
    std::unordered_map<std::string, std::vector<int32_t>> cache;
};

// split a UTF-8 string into codepoint-sized chunks
std::vector<std::string> utf8_chars(const char* s) {
    std::vector<std::string> out;
    const unsigned char* p = reinterpret_cast<const unsigned char*>(s);
    while (*p) {
        int len = 1;
        if ((*p & 0xF8) == 0xF0) len = 4;
        else if ((*p & 0xF0) == 0xE0) len = 3;
        else if ((*p & 0xE0) == 0xC0) len = 2;
        out.emplace_back(reinterpret_cast<const char*>(p), len);
        p += len;
    }
    return out;
}

}  // namespace

extern "C" {

void* bpe_create() { return new Bpe(); }

void bpe_destroy(void* h) { delete static_cast<Bpe*>(h); }

void bpe_add_token(void* h, const char* token, int32_t id) {
    static_cast<Bpe*>(h)->vocab.emplace(token, id);
}

void bpe_add_merge(void* h, const char* left, const char* right, int32_t rank) {
    static_cast<Bpe*>(h)->ranks.emplace(std::make_pair(left, right), rank);
}

static void encode_word_into(Bpe* bpe, const std::string& word, std::vector<int32_t>& out);

// Encode one pre-tokenized, byte-remapped word. Returns the number of ids
// written to out_ids (<= max_out), or -1 on overflow.
int32_t bpe_encode_word(void* h, const char* word, int32_t* out_ids, int32_t max_out) {
    Bpe* bpe = static_cast<Bpe*>(h);
    std::vector<std::string> parts = utf8_chars(word);
    if (parts.empty()) return 0;

    // ranked merge loop: repeatedly merge the lowest-rank adjacent pair
    while (parts.size() > 1) {
        int32_t best_rank = INT32_MAX;
        size_t best_i = SIZE_MAX;
        for (size_t i = 0; i + 1 < parts.size(); ++i) {
            auto it = bpe->ranks.find(std::make_pair(parts[i], parts[i + 1]));
            if (it != bpe->ranks.end() && it->second < best_rank) {
                best_rank = it->second;
                best_i = i;
            }
        }
        if (best_i == SIZE_MAX) break;
        parts[best_i] += parts[best_i + 1];
        parts.erase(parts.begin() + best_i + 1);
    }

    int32_t n = 0;
    for (const auto& part : parts) {
        auto it = bpe->vocab.find(part);
        if (it != bpe->vocab.end()) {
            if (n >= max_out) return -1;
            out_ids[n++] = it->second;
        } else {
            // unmergeable unknown: per-char byte tokens where known
            for (const auto& ch : utf8_chars(part.c_str())) {
                auto cit = bpe->vocab.find(ch);
                if (cit != bpe->vocab.end()) {
                    if (n >= max_out) return -1;
                    out_ids[n++] = cit->second;
                }
            }
        }
    }
    return n;
}

// Batched encode: `words_nl` is pre-tokenized words joined by '\n' (the
// byte-level remapping maps the 0x0A byte to a multi-byte codepoint, so a
// raw '\n' never appears inside a remapped word). One ctypes crossing per
// TEXT instead of per word, with a per-handle word cache. Returns ids
// written, or -1 if out_ids is too small (caller grows and retries).
int32_t bpe_encode_words(void* h, const char* words_nl, int32_t* out_ids, int32_t max_out) {
    Bpe* bpe = static_cast<Bpe*>(h);
    const char* p = words_nl;
    int32_t n = 0;
    while (*p) {
        const char* end = strchr(p, '\n');
        std::string word = end ? std::string(p, end - p) : std::string(p);
        p = end ? end + 1 : p + word.size();
        if (word.empty()) continue;
        auto it = bpe->cache.find(word);
        if (it == bpe->cache.end()) {
            std::vector<int32_t> ids;
            encode_word_into(bpe, word, ids);
            if (bpe->cache.size() < 262144) bpe->cache.emplace(word, ids);
            it = bpe->cache.find(word);
            if (it == bpe->cache.end()) {  // cache full: use local
                for (int32_t id : ids) {
                    if (n >= max_out) return -1;
                    out_ids[n++] = id;
                }
                continue;
            }
        }
        for (int32_t id : it->second) {
            if (n >= max_out) return -1;
            out_ids[n++] = id;
        }
    }
    return n;
}

}  // extern "C"

static void encode_word_into(Bpe* bpe, const std::string& word, std::vector<int32_t>& out) {
    std::vector<std::string> parts = utf8_chars(word.c_str());
    while (parts.size() > 1) {
        int32_t best_rank = INT32_MAX;
        size_t best_i = SIZE_MAX;
        for (size_t i = 0; i + 1 < parts.size(); ++i) {
            auto it = bpe->ranks.find(std::make_pair(parts[i], parts[i + 1]));
            if (it != bpe->ranks.end() && it->second < best_rank) {
                best_rank = it->second;
                best_i = i;
            }
        }
        if (best_i == SIZE_MAX) break;
        parts[best_i] += parts[best_i + 1];
        parts.erase(parts.begin() + best_i + 1);
    }
    for (const auto& part : parts) {
        auto it = bpe->vocab.find(part);
        if (it != bpe->vocab.end()) {
            out.push_back(it->second);
        } else {
            for (const auto& ch : utf8_chars(part.c_str())) {
                auto cit = bpe->vocab.find(ch);
                if (cit != bpe->vocab.end()) out.push_back(cit->second);
            }
        }
    }
}
