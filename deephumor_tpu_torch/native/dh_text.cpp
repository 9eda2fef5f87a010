// deephumor-tpu native text core: batch tokenization + vocabulary encoding.
//
// The host-side hot path of the serving/data pipeline: turning hundreds of
// thousands of caption strings into padded int32 id batches. Replaces the
// per-string Python regex loop (the reference tokenizes caption-by-caption
// in Python, deephumor/data/datasets.py:71-84).
//
// Tokenizer semantics are the ASCII restriction of the reference regexes
// (tokenizers.py:17,26):
//   word-punct:  [<\w'>]+ | [^\w\s]+      (\w = [A-Za-z0-9_])
//   char:        <\w+> | .                ('.' skips '\n')
// The Python wrapper (deephumor_tpu_torch/native/__init__.py) routes non-ASCII
// strings to the Python fallback so behavior stays exact.
//
// C ABI (ctypes):
//   dh_vocab_create(blob, offsets, n)       -> handle
//   dh_vocab_free(handle)
//   dh_vocab_lookup(handle, word)           -> id or -1
//   dh_encode_batch(handle, mode, unk, eos, append_eos, pad,
//                   blob, offsets, n_texts, max_len, out_ids, out_lens)
//   dh_count_tokens(mode, blob, offsets, n_texts, out_counts)

#include <cstdint>
#include <cstring>
#include <string>
#include <string_view>
#include <unordered_map>
#include <vector>

namespace {

struct Vocab {
  std::vector<std::string> storage;
  std::unordered_map<std::string_view, int32_t> index;
};

inline bool is_word(unsigned char c) {
  return (c >= 'a' && c <= 'z') || (c >= 'A' && c <= 'Z') ||
         (c >= '0' && c <= '9') || c == '_';
}

inline bool is_word_class(unsigned char c) {  // the [<\w'>] class
  return is_word(c) || c == '<' || c == '\'' || c == '>';
}

inline bool is_space(unsigned char c) {  // Python ASCII \s
  return c == ' ' || c == '\t' || c == '\n' || c == '\r' || c == '\f' ||
         c == '\v';
}

// Emits [start, end) spans of tokens; returns the count. out may be null
// (count-only mode).
template <typename Emit>
int64_t tokenize_word_punct(std::string_view text, Emit&& emit) {
  int64_t count = 0;
  size_t i = 0, n = text.size();
  while (i < n) {
    unsigned char c = text[i];
    if (is_word_class(c)) {
      size_t j = i + 1;
      while (j < n && is_word_class(text[j])) ++j;
      emit(i, j);
      ++count;
      i = j;
    } else if (!is_space(c)) {
      // the [^\w\s]+ alternative is greedy over ALL non-word non-space
      // chars (including < ' >, which only win at a run START via the
      // first alternative's priority)
      size_t j = i + 1;
      while (j < n && !is_word(text[j]) && !is_space(text[j])) ++j;
      emit(i, j);
      ++count;
      i = j;
    } else {
      ++i;
    }
  }
  return count;
}

template <typename Emit>
int64_t tokenize_char(std::string_view text, Emit&& emit) {
  int64_t count = 0;
  size_t i = 0, n = text.size();
  while (i < n) {
    unsigned char c = text[i];
    if (c == '<') {
      // try <\w+>
      size_t j = i + 1;
      while (j < n && is_word(text[j])) ++j;
      if (j > i + 1 && j < n && text[j] == '>') {
        emit(i, j + 1);
        ++count;
        i = j + 1;
        continue;
      }
    }
    if (c != '\n') {  // '.' does not match newline
      emit(i, i + 1);
      ++count;
    }
    ++i;
  }
  return count;
}

template <typename Emit>
int64_t tokenize(int mode, std::string_view text, Emit&& emit) {
  if (mode == 0) return tokenize_word_punct(text, emit);
  return tokenize_char(text, emit);
}

}  // namespace

extern "C" {

void* dh_vocab_create(const char* blob, const int64_t* offsets, int64_t n) {
  auto* vocab = new Vocab();
  vocab->storage.reserve(n);
  vocab->index.reserve(static_cast<size_t>(n) * 2);
  for (int64_t i = 0; i < n; ++i) {
    vocab->storage.emplace_back(blob + offsets[i],
                                static_cast<size_t>(offsets[i + 1] - offsets[i]));
  }
  // index after storage is stable (no reallocation invalidating views)
  for (int64_t i = 0; i < n; ++i) {
    vocab->index.emplace(std::string_view(vocab->storage[i]),
                         static_cast<int32_t>(i));
  }
  return vocab;
}

void dh_vocab_free(void* handle) { delete static_cast<Vocab*>(handle); }

int32_t dh_vocab_lookup(void* handle, const char* word) {
  auto* vocab = static_cast<Vocab*>(handle);
  auto it = vocab->index.find(std::string_view(word));
  return it == vocab->index.end() ? -1 : it->second;
}

// Encodes n_texts strings into out_ids [n_texts, max_len] (caller
// pre-fills with pad). Tokens beyond max_len are truncated. Returns the
// total number of tokens written.
int64_t dh_encode_batch(void* handle, int mode, int32_t unk_id,
                        int32_t eos_id, int append_eos, int32_t /*pad_id*/,
                        const char* blob, const int64_t* offsets,
                        int64_t n_texts, int32_t max_len, int32_t* out_ids,
                        int32_t* out_lens) {
  auto* vocab = static_cast<Vocab*>(handle);
  int64_t total = 0;
  for (int64_t t = 0; t < n_texts; ++t) {
    std::string_view text(blob + offsets[t],
                          static_cast<size_t>(offsets[t + 1] - offsets[t]));
    int32_t* row = out_ids + t * max_len;
    int32_t len = 0;
    tokenize(mode, text, [&](size_t a, size_t b) {
      if (len >= max_len) return;
      auto it = vocab->index.find(text.substr(a, b - a));
      row[len++] = it == vocab->index.end() ? unk_id : it->second;
    });
    if (append_eos && len < max_len) {
      row[len++] = eos_id;
    }
    out_lens[t] = len;
    total += len;
  }
  return total;
}

// Token counts per text (used for building vocabularies / stats).
void dh_count_tokens(int mode, const char* blob, const int64_t* offsets,
                     int64_t n_texts, int64_t* out_counts) {
  for (int64_t t = 0; t < n_texts; ++t) {
    std::string_view text(blob + offsets[t],
                          static_cast<size_t>(offsets[t + 1] - offsets[t]));
    out_counts[t] = tokenize(mode, text, [](size_t, size_t) {});
  }
}

}  // extern "C"
