// Native compressed-audio window loader (host-side runtime component).
//
// The reference trains off mp3/opus/m4a/aac windows decoded by PyAV — the
// ffmpeg C libraries driven from Python (jukebox/utils/io.py:20-57). Here
// the same libraries (libavformat/libavcodec/libswresample) are driven
// directly from C++: probe duration, seek to a sample window, decode,
// resample to the target rate/stereo float — one C call per window, GIL
// released for the whole decode, so loader threads scale like the
// reference's worker processes.
//
// Also provides a small encoder (jav_encode) so tests can synthesise real
// mp3/ogg/flac fixtures without an ffmpeg CLI in the image.
//
// Build: g++ at first use, jukebox_tpu_torch/ops/_build.py build_host
// (links avformat/avcodec/avutil/swresample).

extern "C" {
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/opt.h>
#include <libswresample/swresample.h>
}

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Decoder {
  AVFormatContext* fmt = nullptr;
  AVCodecContext* dec = nullptr;
  int stream_index = -1;

  ~Decoder() {
    if (dec) avcodec_free_context(&dec);
    if (fmt) avformat_close_input(&fmt);
  }

  int open(const char* path) {
    if (avformat_open_input(&fmt, path, nullptr, nullptr) < 0) return -1;
    if (avformat_find_stream_info(fmt, nullptr) < 0) return -2;
    const AVCodec* codec = nullptr;
    stream_index =
        av_find_best_stream(fmt, AVMEDIA_TYPE_AUDIO, -1, -1, &codec, 0);
    if (stream_index < 0 || !codec) return -3;
    dec = avcodec_alloc_context3(codec);
    if (!dec) return -4;
    AVStream* st = fmt->streams[stream_index];
    if (avcodec_parameters_to_context(dec, st->codecpar) < 0) return -5;
    dec->pkt_timebase = st->time_base;
    if (avcodec_open2(dec, codec, nullptr) < 0) return -6;
    return 0;
  }
};

}  // namespace

extern "C" {

// Probe an audio file. Returns 0 on success.
int jav_probe(const char* path, double* duration_sec, int32_t* sample_rate,
              int32_t* channels) {
  Decoder d;
  if (int rc = d.open(path)) return rc;
  AVStream* st = d.fmt->streams[d.stream_index];
  double dur = 0.0;
  if (st->duration > 0)
    dur = st->duration * av_q2d(st->time_base);
  else if (d.fmt->duration > 0)
    dur = (double)d.fmt->duration / AV_TIME_BASE;
  if (duration_sec) *duration_sec = dur;
  if (sample_rate) *sample_rate = d.dec->sample_rate;
  if (channels) *channels = d.dec->ch_layout.nb_channels;
  return 0;
}

// Decode `n` samples at `offset` (both in samples at `target_sr`) into
// out[2 * n] (channel-major stereo, like wavio). Seeks to the nearest
// keyframe before the window, then drops decoded samples up to the exact
// offset (pts-based). Short reads beyond EOF are zero-filled.
// Returns samples written (>= 0) or a negative error.
int64_t jav_read_window(const char* path, int64_t offset, int64_t n,
                        int32_t target_sr, float* out) {
  Decoder d;
  if (int rc = d.open(path)) return rc;
  AVStream* st = d.fmt->streams[d.stream_index];

  memset(out, 0, sizeof(float) * 2 * (size_t)n);

  // Resampler: decoder's native format -> interleaved float stereo @ target_sr.
  SwrContext* swr = nullptr;
  AVChannelLayout out_layout = AV_CHANNEL_LAYOUT_STEREO;
  AVChannelLayout in_layout;
  av_channel_layout_copy(&in_layout, &d.dec->ch_layout);
  if (in_layout.order == AV_CHANNEL_ORDER_UNSPEC)
    av_channel_layout_default(&in_layout, in_layout.nb_channels);
  int rc = swr_alloc_set_opts2(&swr, &out_layout, AV_SAMPLE_FMT_FLT, target_sr,
                               &in_layout, d.dec->sample_fmt,
                               d.dec->sample_rate, 0, nullptr);
  av_channel_layout_uninit(&in_layout);
  if (rc < 0 || !swr || swr_init(swr) < 0) {
    if (swr) swr_free(&swr);
    return -10;
  }

  // Initial-padding ("skip samples") probe: lossy codecs trim the first N
  // decoded samples at stream start (mp3: LAME 576+529; aac: 1024; opus:
  // pre-skip). The demuxer communicates this as side data on the first
  // packet, but containers disagree on whether pts already reflects it:
  //   * mp3-style: first packet pts = 0, timeline INCLUDES the priming —
  //     a frame with pts P holds media samples from P*tb - skip/sr;
  //   * mov/ogg-style: first packet pts = -skip (edit-list/pre-skip
  //     timeline), so media sample 0 already sits at pts 0 and no
  //     correction is needed.
  // Folding a negative first-packet pts into the skip handles both; the
  // decoder itself discards the side-data samples and bumps the trimmed
  // frame's pts forward, so the frame_sec formula below is uniform.
  double skip_sec = 0.0;
  {
    AVPacket* p0 = av_packet_alloc();
    while (av_read_frame(d.fmt, p0) >= 0) {
      if (p0->stream_index == d.stream_index) {
        size_t sd_size = 0;
        const uint8_t* sd = av_packet_get_side_data(
            p0, AV_PKT_DATA_SKIP_SAMPLES, &sd_size);
        if (sd && sd_size >= 4 && d.dec->sample_rate > 0) {
          uint32_t skip = sd[0] | sd[1] << 8 | sd[2] << 16 | (uint32_t)sd[3] << 24;
          skip_sec = (double)skip / d.dec->sample_rate;
        }
        if (p0->pts != AV_NOPTS_VALUE && p0->pts < 0)
          skip_sec += p0->pts * av_q2d(st->time_base);
        if (skip_sec < 0.0) skip_sec = 0.0;
        if (!sd && d.dec->codec_id == AV_CODEC_ID_AAC &&
            d.fmt->iformat && d.fmt->iformat->name &&
            strcmp(d.fmt->iformat->name, "aac") == 0 &&
            d.dec->sample_rate > 0) {
          // Raw ADTS carries no priming metadata; AAC-LC encoders emit a
          // standard 1024-sample delay. Assume it (PyAV/ffmpeg leave the
          // stream shifted instead). Seek stays bitrate-estimated — ADTS
          // windows are approximate by nature.
          skip_sec = 1024.0 / d.dec->sample_rate;
        }
        av_packet_unref(p0);
        break;
      }
      av_packet_unref(p0);
    }
    av_packet_free(&p0);
  }

  // Seek to a keyframe at/before the window start, with ~0.2 s of pre-roll
  // so decoder priming distortion (mp3 bit reservoir) lands in the
  // discarded region; pts-based trimming takes care of the exact offset.
  double start_sec = (double)offset / target_sr;
  double seek_sec = start_sec + skip_sec - 0.2;
  if (seek_sec < 0.0) seek_sec = 0.0;
  int64_t seek_pts = (int64_t)(seek_sec / av_q2d(st->time_base));
  if (av_seek_frame(d.fmt, d.stream_index, seek_pts, AVSEEK_FLAG_BACKWARD) < 0)
    av_seek_frame(d.fmt, d.stream_index, 0, AVSEEK_FLAG_BACKWARD);
  avcodec_flush_buffers(d.dec);

  AVPacket* pkt = av_packet_alloc();
  AVFrame* frame = av_frame_alloc();
  // interleaved stereo staging for one resampled frame
  std::vector<float> stage;
  int64_t to_skip = -1;  // resampled samples to drop before the window
  int64_t written = 0;
  bool draining = false;

  while (written < n) {
    if (!draining) {
      int pr = av_read_frame(d.fmt, pkt);
      if (pr < 0) {
        draining = true;
        avcodec_send_packet(d.dec, nullptr);
      } else {
        if (pkt->stream_index != d.stream_index) {
          av_packet_unref(pkt);
          continue;
        }
        if (avcodec_send_packet(d.dec, pkt) < 0) {
          av_packet_unref(pkt);
          continue;
        }
        av_packet_unref(pkt);
      }
    }
    int fr;
    while ((fr = avcodec_receive_frame(d.dec, frame)) == 0 && written < n) {
      if (to_skip < 0) {
        // First decoded frame: position of the seek point in target samples.
        int64_t pts = frame->pts != AV_NOPTS_VALUE ? frame->pts
                      : frame->best_effort_timestamp;
        // A frame with pts P holds media samples from P*tb - skip_sec:
        // pts timelines do not reflect the initial trim (and when the
        // decoder auto-trims at stream start, it bumps the trimmed
        // frame's pts forward by the trim — same formula either way).
        double frame_sec = pts != AV_NOPTS_VALUE
                               ? pts * av_q2d(st->time_base) - skip_sec
                               : start_sec;
        to_skip = (int64_t)((start_sec - frame_sec) * target_sr + 0.5);
        if (to_skip < 0) to_skip = 0;
      }
      int out_cap = swr_get_out_samples(swr, frame->nb_samples);
      if (out_cap <= 0) out_cap = frame->nb_samples * 4 + 256;
      stage.resize((size_t)out_cap * 2);
      uint8_t* dst[1] = {(uint8_t*)stage.data()};
      int got = swr_convert(swr, dst, out_cap,
                            (const uint8_t**)frame->extended_data,
                            frame->nb_samples);
      if (got <= 0) continue;
      int64_t use_from = to_skip < got ? to_skip : got;
      to_skip -= use_from;
      int64_t avail = got - use_from;
      int64_t take = avail < (n - written) ? avail : (n - written);
      for (int64_t t = 0; t < take; ++t) {
        out[written + t] = stage[(size_t)(use_from + t) * 2];
        out[n + written + t] = stage[(size_t)(use_from + t) * 2 + 1];
      }
      written += take;
    }
    if (draining && fr == AVERROR_EOF) break;
    if (draining && fr == AVERROR(EAGAIN)) break;  // defensive
  }

  // Flush the resampler tail (rate conversion delay) if still short.
  if (written < n && to_skip >= 0) {
    int out_cap = (int)(n - written) + 256;
    stage.resize((size_t)out_cap * 2);
    uint8_t* dst[1] = {(uint8_t*)stage.data()};
    int got = swr_convert(swr, dst, out_cap, nullptr, 0);
    if (got > 0) {
      int64_t use_from = to_skip < got ? to_skip : got;
      int64_t take = got - use_from;
      if (take > n - written) take = n - written;
      for (int64_t t = 0; t < take; ++t) {
        out[written + t] = stage[(size_t)(use_from + t) * 2];
        out[n + written + t] = stage[(size_t)(use_from + t) * 2 + 1];
      }
      written += take;
    }
  }

  av_frame_free(&frame);
  av_packet_free(&pkt);
  swr_free(&swr);
  return written;
}

// Encode interleaved float `data[n_frames * channels]` at rate `sr` to
// `path`; the container/codec are chosen from the file extension (mp3 ->
// libmp3lame, ogg -> vorbis, flac -> flac, ...). Returns 0 on success.
int jav_encode(const char* path, const float* data, int64_t n_frames,
               int32_t channels, int32_t sr) {
  AVFormatContext* fmt = nullptr;
  if (avformat_alloc_output_context2(&fmt, nullptr, nullptr, path) < 0 || !fmt)
    return -1;
  const AVCodec* codec = avcodec_find_encoder(fmt->oformat->audio_codec);
  if (!codec) {
    avformat_free_context(fmt);
    return -2;
  }
  AVCodecContext* enc = avcodec_alloc_context3(codec);
  enc->sample_rate = sr;
  av_channel_layout_default(&enc->ch_layout, channels);
  enc->sample_fmt = codec->sample_fmts ? codec->sample_fmts[0] : AV_SAMPLE_FMT_FLTP;
  enc->bit_rate = 128000;
  enc->time_base = {1, sr};
  if (fmt->oformat->flags & AVFMT_GLOBALHEADER)
    enc->flags |= AV_CODEC_FLAG_GLOBAL_HEADER;
  int ret = -3;
  AVStream* st = nullptr;
  SwrContext* swr = nullptr;
  AVFrame* frame = nullptr;
  AVPacket* pkt = av_packet_alloc();
  int64_t pos = 0, pts = 0;
  int frame_size = 0;

  if (avcodec_open2(enc, codec, nullptr) < 0) goto done;
  st = avformat_new_stream(fmt, nullptr);
  if (!st || avcodec_parameters_from_context(st->codecpar, enc) < 0) goto done;
  st->time_base = enc->time_base;
  if (!(fmt->oformat->flags & AVFMT_NOFILE) &&
      avio_open(&fmt->pb, path, AVIO_FLAG_WRITE) < 0)
    goto done;
  if (avformat_write_header(fmt, nullptr) < 0) goto done;

  {
    AVChannelLayout in_layout;
    av_channel_layout_default(&in_layout, channels);
    if (swr_alloc_set_opts2(&swr, &enc->ch_layout, enc->sample_fmt, sr,
                            &in_layout, AV_SAMPLE_FMT_FLT, sr, 0,
                            nullptr) < 0 ||
        swr_init(swr) < 0) {
      av_channel_layout_uninit(&in_layout);
      goto done;
    }
    av_channel_layout_uninit(&in_layout);
  }

  frame_size = enc->frame_size > 0 ? enc->frame_size : 1024;
  frame = av_frame_alloc();
  while (pos < n_frames) {
    int64_t chunk = n_frames - pos < frame_size ? n_frames - pos : frame_size;
    frame->nb_samples = (int)chunk;
    frame->format = enc->sample_fmt;
    av_channel_layout_copy(&frame->ch_layout, &enc->ch_layout);
    frame->sample_rate = sr;
    if (av_frame_get_buffer(frame, 0) < 0) goto done;
    const uint8_t* src[1] = {(const uint8_t*)(data + pos * channels)};
    if (swr_convert(swr, frame->extended_data, (int)chunk, src, (int)chunk) < 0)
      goto done;
    frame->pts = pts;
    pts += chunk;
    if (avcodec_send_frame(enc, frame) < 0) goto done;
    while (avcodec_receive_packet(enc, pkt) == 0) {
      av_packet_rescale_ts(pkt, enc->time_base, st->time_base);
      pkt->stream_index = st->index;
      av_interleaved_write_frame(fmt, pkt);
    }
    av_frame_unref(frame);
    pos += chunk;
  }
  avcodec_send_frame(enc, nullptr);  // flush
  while (avcodec_receive_packet(enc, pkt) == 0) {
    av_packet_rescale_ts(pkt, enc->time_base, st->time_base);
    pkt->stream_index = st->index;
    av_interleaved_write_frame(fmt, pkt);
  }
  av_write_trailer(fmt);
  ret = 0;

done:
  if (pkt) av_packet_free(&pkt);
  if (frame) av_frame_free(&frame);
  if (swr) swr_free(&swr);
  if (enc) avcodec_free_context(&enc);
  if (fmt) {
    if (!(fmt->oformat->flags & AVFMT_NOFILE) && fmt->pb)
      avio_closep(&fmt->pb);
    avformat_free_context(fmt);
  }
  return ret;
}

}  // extern "C"
