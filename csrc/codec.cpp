// Native data-marshalling layer: the host-side hot loops.
//
// Plays the role of the reference's byte-conversion utilities and NTT bank
// scatter/gather (/root/reference/src/utils.rs:117-130,
// /root/reference/src/ingo_ntt/ntt_data.rs:80-156) — the host-CPU work that
// sits between wire bytes and device buffers.  Exposed through ctypes
// (blaze_tpu/native/codec.py) with a numpy fallback.
//
// Wire format recap: every field element is a fixed-width little-endian
// byte string; device format is uint32 lanes each holding one 16-bit limb.

#include <cstdint>
#include <cstddef>
#include <cstring>

extern "C" {

// LE element bytes -> uint32 limb lanes.  nbytes must be even; limbs per
// element = nbytes / 2.  dst has n_elems * (nbytes / 2) uint32 slots.
void blz_bytes_to_limbs(const uint8_t* src, uint32_t* dst, size_t n_elems,
                        int nbytes) {
  const size_t nl = static_cast<size_t>(nbytes) / 2;
  for (size_t e = 0; e < n_elems; ++e) {
    const uint8_t* s = src + e * nbytes;
    uint32_t* d = dst + e * nl;
    for (size_t i = 0; i < nl; ++i) {
      d[i] = static_cast<uint32_t>(s[2 * i]) |
             (static_cast<uint32_t>(s[2 * i + 1]) << 8);
    }
  }
}

// uint32 limb lanes -> LE element bytes (limbs must be < 2^16).
void blz_limbs_to_bytes(const uint32_t* src, uint8_t* dst, size_t n_elems,
                        int nbytes) {
  const size_t nl = static_cast<size_t>(nbytes) / 2;
  for (size_t e = 0; e < n_elems; ++e) {
    const uint32_t* s = src + e * nl;
    uint8_t* d = dst + e * nbytes;
    for (size_t i = 0; i < nl; ++i) {
      d[2 * i] = static_cast<uint8_t>(s[i] & 0xff);
      d[2 * i + 1] = static_cast<uint8_t>((s[i] >> 8) & 0xff);
    }
  }
}

// Strided bank split: element i of the input stream goes to bank
// (i % nbanks), slot (i / nbanks).  This is our HBM-bank layout analog of
// the reference's 16-bank preprocess (ntt_data.rs:80-111); the FPGA's
// group/slice/batch hierarchy is hardware-specific and intentionally not
// reproduced.  elem_bytes is the wire size of one element.
void blz_bank_split(const uint8_t* src, uint8_t* dst, size_t n_elems,
                    int elem_bytes, int nbanks) {
  const size_t per_bank = n_elems / nbanks;
  for (size_t i = 0; i < n_elems; ++i) {
    const size_t bank = i % nbanks;
    const size_t slot = i / nbanks;
    std::memcpy(dst + (bank * per_bank + slot) * elem_bytes,
                src + i * elem_bytes, elem_bytes);
  }
}

// Inverse of blz_bank_split (postprocess gather, ntt_data.rs:113-156 analog).
void blz_bank_merge(const uint8_t* src, uint8_t* dst, size_t n_elems,
                    int elem_bytes, int nbanks) {
  const size_t per_bank = n_elems / nbanks;
  for (size_t i = 0; i < n_elems; ++i) {
    const size_t bank = i % nbanks;
    const size_t slot = i / nbanks;
    std::memcpy(dst + i * elem_bytes,
                src + (bank * per_bank + slot) * elem_bytes, elem_bytes);
  }
}

// Tiled transpose of an (rows x cols) matrix of elem_bytes-sized elements —
// the four-step NTT host-side reorder for out-of-core sizes.
void blz_transpose(const uint8_t* src, uint8_t* dst, size_t rows, size_t cols,
                   int elem_bytes) {
  const size_t TILE = 64;
  for (size_t r0 = 0; r0 < rows; r0 += TILE) {
    for (size_t c0 = 0; c0 < cols; c0 += TILE) {
      const size_t rmax = (r0 + TILE < rows) ? r0 + TILE : rows;
      const size_t cmax = (c0 + TILE < cols) ? c0 + TILE : cols;
      for (size_t r = r0; r < rmax; ++r) {
        for (size_t c = c0; c < cmax; ++c) {
          std::memcpy(dst + (c * rows + r) * elem_bytes,
                      src + (r * cols + c) * elem_bytes, elem_bytes);
        }
      }
    }
  }
}

}  // extern "C"
