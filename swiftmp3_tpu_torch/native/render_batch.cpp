// Batched entry point of the native frame renderer: one call renders a
// range of a batch's streams straight from the chunk program's packed
// output, with no per-stream work in the caller.
//
// frame_render.cpp is a verbatim copy of the reference renderer, so the
// batch entry lives in this translation unit, which includes it and calls
// the same build_head_side and push_frame as mp3_render_frames_packed: the
// bytes, frame sizes and counters are those of one mp3_render_frames_packed
// call a stream.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -o libmp3render.so render_batch.cpp

#include "frame_render.cpp"

namespace {

// The meta fields of a packed frame, in the order of mp3_render_batch's
// `layout` argument (the order of native.lib.BATCH_FIELDS).
enum MetaField {
    M_BITRATE_INDEX, M_PADDING, M_MDB, M_SLOT, M_PART23, M_BIG_VALUES,
    M_GAIN, M_BLOCK_TYPE, M_PREFLAG, M_REGION0, M_REGION1,
    M_SUBBLOCK_GAIN, M_TABLE_SELECT, M_COUNT1TABLE, M_SCALEFAC_COMPRESS,
    M_SCFSI, M_MODE_EXT, M_FIELDS
};

// Fill the CRC table while the library loads, before any thread renders
// (crc_init fills it lazily, unguarded).
const bool crc_ready = (crc_init(), true);

}  // namespace

extern "C" {

// Render n_rows streams. Row r's frames lie at rows[r] + f * frame_stride,
// f < counts[r]: each is `cap` bytes of device-packed main_data, then
// meta_words int32 words of side information (at any alignment), each
// field at the word offset layout[field]. The frame's main_data length is
// (sum of its part2_3_length + 7) / 8, as pipeline.fetch_outputs computes
// it. states[r] is row r's stream state (mp3_stream_new). Row r writes its
// bytes to arena + r * slot_capacity, the sizes of the frames it emits to
// frame_sizes_out + r * sizes_stride, its byte count (or -1 if slot_capacity
// is too small, -2 if a frame's main_data exceeds cap) to written_out[r]
// and its emitted frame count to n_emitted_out[r].
void mp3_render_batch(void* const* states, const uint8_t* const* rows,
                      const int32_t* counts, int n_rows, int cap,
                      int64_t frame_stride, const int32_t* layout,
                      int meta_words, uint8_t* arena, int64_t slot_capacity,
                      int32_t* frame_sizes_out, int64_t sizes_stride,
                      int64_t* written_out, int32_t* n_emitted_out) {
    std::vector<int32_t> meta(static_cast<size_t>(meta_words));
    int32_t* m = meta.data();
    for (int r = 0; r < n_rows; r++) {
        auto* s = static_cast<StreamState*>(states[r]);
        const int G = (s->lsf ? 1 : 2) * s->channels;
        uint8_t* out = arena + static_cast<int64_t>(r) * slot_capacity;
        int32_t* sizes = frame_sizes_out + static_cast<int64_t>(r) * sizes_stride;
        int64_t written = 0;
        int n_emitted = 0;
        int64_t status = 0;
        for (int f = 0; f < counts[r]; f++) {
            const uint8_t* frame = rows[r] + static_cast<int64_t>(f) * frame_stride;
            std::memcpy(m, frame + cap, static_cast<size_t>(meta_words) * sizeof(int32_t));
            const int32_t* part23 = m + layout[M_PART23];
            int bits = 0;
            for (int g = 0; g < G; g++) bits += part23[g];
            const int hb = (bits + 7) / 8;
            if (hb > cap) {
                status = -2;
                break;
            }
            const int mdb = m[layout[M_MDB]];
            std::vector<uint8_t> head_side = build_head_side(
                s, 0, m[layout[M_BITRATE_INDEX]], m[layout[M_PADDING]], mdb,
                part23, m + layout[M_BIG_VALUES], m + layout[M_GAIN],
                m + layout[M_BLOCK_TYPE], m + layout[M_PREFLAG],
                m + layout[M_REGION0], m + layout[M_REGION1],
                m + layout[M_SUBBLOCK_GAIN], m + layout[M_SCALEFAC_COMPRESS],
                m + layout[M_TABLE_SELECT], m + layout[M_COUNT1TABLE],
                m + layout[M_SCFSI], m + layout[M_MODE_EXT]);
            if (push_frame(s, frame, static_cast<size_t>(hb), mdb,
                           std::move(head_side), m[layout[M_SLOT]], out,
                           slot_capacity, &written, sizes, &n_emitted) < 0) {
                status = -1;
                break;
            }
        }
        written_out[r] = status < 0 ? status : written;
        n_emitted_out[r] = n_emitted;
    }
}

}  // extern "C"
