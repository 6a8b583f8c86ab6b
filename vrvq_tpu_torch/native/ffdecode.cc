// General compressed-audio decode via the system FFmpeg libraries
// (libavformat/libavcodec/libswresample): the .mp4/.m4a (AAC) readers of
// vrvq_tpu_torch, a copy of vrvq_tpu/native/io/ffdecode.cc with the same
// extern "C" API. vrvq_tpu_torch/data/ffdecode.py builds it with g++ at
// first use into vrvq_tpu_torch/kernels/_build/ and raises
// UnsupportedFormatError where the FFmpeg headers or libraries are absent.
//
// Also exposes a minimal AAC-in-mp4 *encoder* used only by the tests to
// generate fixtures.

extern "C" {
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/channel_layout.h>
#include <libavutil/opt.h>
#include <libswresample/swresample.h>
}

#include <algorithm>
#include <cstring>
#include <vector>

namespace {

// Training corpora contain imperfect files; keep libav's per-file
// warnings/info off the process stderr (the Python loaders report
// failures through their own warn-once path).
struct QuietLogs {
  QuietLogs() { av_log_set_level(AV_LOG_ERROR); }
} quiet_logs;

struct Decoder {
  AVFormatContext* fmt = nullptr;
  AVCodecContext* dec = nullptr;
  SwrContext* swr = nullptr;
  AVPacket* pkt = nullptr;
  AVFrame* frame = nullptr;
  int stream_index = -1;
  int sample_rate = 0;
  int channels = 0;

  ~Decoder() {
    if (swr) swr_free(&swr);
    if (dec) avcodec_free_context(&dec);
    if (fmt) avformat_close_input(&fmt);
    if (pkt) av_packet_free(&pkt);
    if (frame) av_frame_free(&frame);
  }

  // 0 on success, <0 AVERROR otherwise.
  int open(const char* path) {
    int rc = avformat_open_input(&fmt, path, nullptr, nullptr);
    if (rc < 0) return rc;
    rc = avformat_find_stream_info(fmt, nullptr);
    if (rc < 0) return rc;
    const AVCodec* codec = nullptr;
    rc = av_find_best_stream(fmt, AVMEDIA_TYPE_AUDIO, -1, -1, &codec, 0);
    if (rc < 0) return rc;
    stream_index = rc;
    AVStream* st = fmt->streams[stream_index];
    dec = avcodec_alloc_context3(codec);
    if (!dec) return AVERROR(ENOMEM);
    rc = avcodec_parameters_to_context(dec, st->codecpar);
    if (rc < 0) return rc;
    rc = avcodec_open2(dec, codec, nullptr);
    if (rc < 0) return rc;
    sample_rate = dec->sample_rate;
    channels = dec->ch_layout.nb_channels;
    if (sample_rate <= 0 || channels <= 0) return AVERROR(EINVAL);
    // interleaved f32 at the native rate/channel count
    AVChannelLayout out_layout;
    av_channel_layout_copy(&out_layout, &dec->ch_layout);
    rc = swr_alloc_set_opts2(&swr, &out_layout, AV_SAMPLE_FMT_FLT,
                             sample_rate, &dec->ch_layout, dec->sample_fmt,
                             sample_rate, 0, nullptr);
    av_channel_layout_uninit(&out_layout);
    if (rc < 0) return rc;
    rc = swr_init(swr);
    if (rc < 0) return rc;
    pkt = av_packet_alloc();
    frame = av_frame_alloc();
    return (pkt && frame) ? 0 : AVERROR(ENOMEM);
  }

  // Best-effort total frames from container metadata (exact for mp4,
  // an estimate for raw streams); <0 when unknown.
  long meta_frames() const {
    AVStream* st = fmt->streams[stream_index];
    if (st->duration != AV_NOPTS_VALUE && st->time_base.den > 0) {
      return (long)av_rescale(st->duration, (int64_t)sample_rate *
                                  st->time_base.num, st->time_base.den);
    }
    if (fmt->duration != AV_NOPTS_VALUE) {
      return (long)av_rescale(fmt->duration, sample_rate, AV_TIME_BASE);
    }
    return -1;
  }
};

}  // namespace

extern "C" {

// Header-level stream info. Returns 0 on success. frames may be -1 when
// the container doesn't record a duration.
int vrvqff_audio_info(const char* path, int* sample_rate, int* channels,
                      long* frames) {
  Decoder d;
  if (d.open(path) < 0) return -1;
  *sample_rate = d.sample_rate;
  *channels = d.channels;
  *frames = d.meta_frames();
  return 0;
}

// Decode [offset, offset+duration) seconds (duration<0: to EOF) into
// `out` (interleaved f32, capacity max_floats). Returns frames decoded,
// or <0 on error. Decodes sequentially from the stream start and
// discards up to the exact offset sample: pts-based seeking cannot index
// the decoded-sample timeline consistently across muxers (untrimmed AAC
// priming shifts it by an encoder-dependent constant), and a windowed
// read MUST equal the same slice of a full decode for the loaders'
// excerpt determinism. AAC decode runs far above realtime, so the
// discard costs tens of ms for song-length offsets.
long vrvqff_read_audio(const char* path, double offset, double duration,
                       float* out, long max_floats, int* sample_rate,
                       int* channels) {
  Decoder d;
  if (d.open(path) < 0) return -1;
  *sample_rate = d.sample_rate;
  *channels = d.channels;
  const long start = (long)(offset * d.sample_rate + 0.5);
  const long want =
      duration < 0 ? -1 : (long)(duration * d.sample_rate + 0.5);
  const long cap_frames = max_floats / d.channels;

  long to_skip = start;

  long got = 0;  // frames written
  bool draining = false;
  std::vector<float> conv;
  while (true) {
    if (!draining) {
      int rc = av_read_frame(d.fmt, d.pkt);
      if (rc < 0) {
        draining = true;
        avcodec_send_packet(d.dec, nullptr);
      } else {
        if (d.pkt->stream_index != d.stream_index) {
          av_packet_unref(d.pkt);
          continue;
        }
        rc = avcodec_send_packet(d.dec, d.pkt);
        av_packet_unref(d.pkt);
        if (rc < 0 && rc != AVERROR(EAGAIN)) return got > 0 ? got : -2;
      }
    }
    while (true) {
      int rc = avcodec_receive_frame(d.dec, d.frame);
      if (rc == AVERROR(EAGAIN)) break;
      if (rc == AVERROR_EOF) return got;
      if (rc < 0) return got > 0 ? got : -3;
      int n = d.frame->nb_samples;
      conv.resize((size_t)n * d.channels);
      uint8_t* outp = (uint8_t*)conv.data();
      int converted =
          swr_convert(d.swr, &outp, n,
                      (const uint8_t**)d.frame->extended_data, n);
      av_frame_unref(d.frame);
      if (converted <= 0) continue;
      long off = 0;
      if (to_skip > 0) {
        off = std::min((long)converted, to_skip);
        to_skip -= off;
      }
      long avail = converted - off;
      if (avail <= 0) continue;
      long take = avail;
      if (want >= 0) take = std::min(take, want - got);
      take = std::min(take, cap_frames - got);
      if (take > 0) {
        std::memcpy(out + got * d.channels,
                    conv.data() + off * d.channels,
                    (size_t)take * d.channels * sizeof(float));
        got += take;
      }
      if ((want >= 0 && got >= want) || got >= cap_frames) return got;
    }
  }
}

// Test-fixture encoder: interleaved f32 (frames x channels) -> AAC in an
// .mp4/.m4a container. Returns 0 on success.
int vrvqff_encode_aac(const char* path, const float* data, long frames,
                      int channels, int sample_rate, int bitrate) {
  AVFormatContext* fmt = nullptr;
  if (avformat_alloc_output_context2(&fmt, nullptr, nullptr, path) < 0 ||
      !fmt)
    return -1;
  const AVCodec* codec = avcodec_find_encoder(AV_CODEC_ID_AAC);
  if (!codec) {
    avformat_free_context(fmt);
    return -2;
  }
  AVCodecContext* enc = avcodec_alloc_context3(codec);
  AVStream* st = avformat_new_stream(fmt, nullptr);
  SwrContext* swr = nullptr;
  AVFrame* frame = nullptr;
  AVPacket* pkt = av_packet_alloc();
  int rc = -3;

  do {
    if (!enc || !st || !pkt) break;
    enc->sample_rate = sample_rate;
    av_channel_layout_default(&enc->ch_layout, channels);
    enc->sample_fmt = AV_SAMPLE_FMT_FLTP;  // native aac encoder format
    enc->bit_rate = bitrate;
    enc->time_base = {1, sample_rate};
    if (fmt->oformat->flags & AVFMT_GLOBALHEADER)
      enc->flags |= AV_CODEC_FLAG_GLOBAL_HEADER;
    if (avcodec_open2(enc, codec, nullptr) < 0) break;
    if (avcodec_parameters_from_context(st->codecpar, enc) < 0) break;
    st->time_base = enc->time_base;
    if (!(fmt->oformat->flags & AVFMT_NOFILE) &&
        avio_open(&fmt->pb, path, AVIO_FLAG_WRITE) < 0)
      break;
    if (avformat_write_header(fmt, nullptr) < 0) break;

    if (swr_alloc_set_opts2(&swr, &enc->ch_layout, AV_SAMPLE_FMT_FLTP,
                            sample_rate, &enc->ch_layout, AV_SAMPLE_FMT_FLT,
                            sample_rate, 0, nullptr) < 0 ||
        swr_init(swr) < 0)
      break;

    frame = av_frame_alloc();
    if (!frame) break;
    const int chunk = enc->frame_size > 0 ? enc->frame_size : 1024;
    long pos = 0;
    bool failed = false;
    auto drain = [&](bool flush) -> bool {
      if (flush) avcodec_send_frame(enc, nullptr);
      while (true) {
        int r = avcodec_receive_packet(enc, pkt);
        if (r == AVERROR(EAGAIN) || r == AVERROR_EOF) return true;
        if (r < 0) return false;
        av_packet_rescale_ts(pkt, enc->time_base, st->time_base);
        pkt->stream_index = st->index;
        if (av_interleaved_write_frame(fmt, pkt) < 0) return false;
      }
    };
    while (pos < frames && !failed) {
      const int n = (int)std::min((long)chunk, frames - pos);
      frame->nb_samples = n;
      frame->format = AV_SAMPLE_FMT_FLTP;
      av_channel_layout_copy(&frame->ch_layout, &enc->ch_layout);
      if (av_frame_get_buffer(frame, 0) < 0) {
        failed = true;
        break;
      }
      const uint8_t* in = (const uint8_t*)(data + pos * channels);
      if (swr_convert(swr, frame->data, n, &in, n) < 0) {
        failed = true;
        break;
      }
      frame->pts = pos;
      pos += n;
      if (avcodec_send_frame(enc, frame) < 0 || !drain(false)) failed = true;
      av_frame_unref(frame);
    }
    if (failed || !drain(true)) break;
    if (av_write_trailer(fmt) < 0) break;
    rc = 0;
  } while (false);

  if (frame) av_frame_free(&frame);
  if (swr) swr_free(&swr);
  if (pkt) av_packet_free(&pkt);
  if (enc) avcodec_free_context(&enc);
  if (fmt) {
    if (!(fmt->oformat->flags & AVFMT_NOFILE) && fmt->pb)
      avio_closep(&fmt->pb);
    avformat_free_context(fmt);
  }
  return rc;
}

}  // extern "C"
