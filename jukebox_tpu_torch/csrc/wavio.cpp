// Native audio-window loader (host-side runtime component).
//
// The reference feeds training through PyAV (ffmpeg C bindings) worker
// processes (jukebox/utils/io.py:20-57, data loaded in DataLoader workers).
// Here the hot host path — seeking a sample window out of a PCM wav file,
// int->float conversion, channel handling and polyphase-free linear
// resampling — is a small C++ library called via ctypes from the thread-pool
// loader; it releases the GIL implicitly (pure C call), so loader threads
// scale.
//
// Build: g++ at first use, jukebox_tpu_torch/ops/_build.py build_host.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cstdlib>

extern "C" {

struct WavInfo {
  int32_t sample_rate;
  int32_t channels;
  int32_t bits;
  int32_t format;  // 1 = integer PCM, 3 = IEEE float
  int64_t n_frames;
  int64_t data_offset;  // byte offset of pcm data
};

// Parse RIFF/WAVE headers. Returns 0 on success.
int wav_probe(const char* path, WavInfo* info) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  char riff[4], wave[4];
  uint32_t riff_size;
  if (fread(riff, 1, 4, f) != 4 || memcmp(riff, "RIFF", 4) ||
      fread(&riff_size, 4, 1, f) != 1 ||
      fread(wave, 1, 4, f) != 4 || memcmp(wave, "WAVE", 4)) {
    fclose(f);
    return -2;
  }
  uint16_t fmt = 0, channels = 0, bits = 0;
  uint32_t rate = 0;
  int64_t data_off = -1, data_size = 0;
  // walk chunks
  for (;;) {
    char id[4];
    uint32_t size;
    if (fread(id, 1, 4, f) != 4 || fread(&size, 4, 1, f) != 1) break;
    if (!memcmp(id, "fmt ", 4)) {
      uint16_t block_align;
      uint32_t byte_rate;
      if (fread(&fmt, 2, 1, f) != 1 || fread(&channels, 2, 1, f) != 1 ||
          fread(&rate, 4, 1, f) != 1 || fread(&byte_rate, 4, 1, f) != 1 ||
          fread(&block_align, 2, 1, f) != 1 || fread(&bits, 2, 1, f) != 1) {
        fclose(f);
        return -3;
      }
      if (size > 16) fseek(f, size - 16, SEEK_CUR);
    } else if (!memcmp(id, "data", 4)) {
      data_off = ftell(f);
      data_size = size;
      fseek(f, (size + 1) & ~1u, SEEK_CUR);
    } else {
      fseek(f, (size + 1) & ~1u, SEEK_CUR);
    }
    if (data_off >= 0 && rate) break;
  }
  fclose(f);
  if (data_off < 0 || !rate || !channels || !bits) return -4;
  if (fmt != 1 && fmt != 3) return -5;  // PCM or float
  if (fmt == 3 && bits != 32 && bits != 64) return -5;
  info->sample_rate = (int32_t)rate;
  info->channels = (int32_t)channels;
  info->bits = (int32_t)bits;
  info->format = (int32_t)fmt;
  info->n_frames = data_size / (channels * (bits / 8));
  info->data_offset = data_off;
  return 0;
}

// Read `n_frames` frames starting at `start` into out[channels * n_frames]
// (channel-major: out[c * n_frames + t]), converting to float32 in [-1, 1].
// Frames beyond EOF are zero-filled. Returns frames actually read.
int64_t wav_read_window(const char* path, int64_t start, int64_t n_frames,
                        float* out, int32_t out_channels) {
  WavInfo info;
  if (wav_probe(path, &info) != 0) return -1;
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  const int bytes_per = info.bits / 8;
  const int frame_bytes = info.channels * bytes_per;
  int64_t avail = info.n_frames - start;
  if (avail < 0) avail = 0;
  int64_t to_read = avail < n_frames ? avail : n_frames;

  memset(out, 0, sizeof(float) * (size_t)out_channels * (size_t)n_frames);
  if (to_read > 0) {
    fseek(f, (long)(info.data_offset + start * frame_bytes), SEEK_SET);
    uint8_t* buf = (uint8_t*)malloc((size_t)to_read * frame_bytes);
    size_t got = fread(buf, frame_bytes, (size_t)to_read, f);
    for (int64_t t = 0; t < (int64_t)got; ++t) {
      for (int c = 0; c < out_channels; ++c) {
        int src_c = c < info.channels ? c : info.channels - 1;
        const uint8_t* p = buf + t * frame_bytes + src_c * bytes_per;
        float v = 0.f;
        if (info.format == 3) {  // IEEE float (fmt 3): raw float samples
          if (info.bits == 32) {
            memcpy(&v, p, 4);
          } else {  // 64-bit double (probe rejects other float widths)
            double d;
            memcpy(&d, p, 8);
            v = (float)d;
          }
        } else if (info.bits == 16) {
          int16_t s;
          memcpy(&s, p, 2);
          v = (float)s / 32768.f;
        } else if (info.bits == 32) {
          int32_t s;
          memcpy(&s, p, 4);
          v = (float)s / 2147483648.f;
        } else if (info.bits == 8) {
          v = ((float)(*p) - 128.f) / 128.f;
        } else if (info.bits == 24) {
          int32_t s = (int32_t)((uint32_t)p[0] << 8 | (uint32_t)p[1] << 16 |
                                (uint32_t)p[2] << 24) >> 8;
          v = (float)s / 8388608.f;
        }
        out[(size_t)c * n_frames + t] = v;
      }
    }
    free(buf);
  }
  fclose(f);
  return to_read;
}

// Linear resample in[channels][n_in] -> out[channels][n_out].
void resample_linear(const float* in, int64_t n_in, float* out, int64_t n_out,
                     int32_t channels) {
  if (n_in <= 1 || n_out <= 0) return;
  const double step = (double)n_in / (double)n_out;
  for (int c = 0; c < channels; ++c) {
    const float* src = in + (size_t)c * n_in;
    float* dst = out + (size_t)c * n_out;
    for (int64_t i = 0; i < n_out; ++i) {
      double pos = i * step;
      int64_t i0 = (int64_t)pos;
      if (i0 >= n_in - 1) i0 = n_in - 2;
      double frac = pos - (double)i0;
      dst[i] = (float)((1.0 - frac) * src[i0] + frac * src[i0 + 1]);
    }
  }
}

}  // extern "C"
