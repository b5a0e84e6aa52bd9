// Native frame renderer: the host-side byte path of the TPU MP3 framework.
//
// Renders fixed-shape device outputs (quantized spectra + side-info integers)
// into MP3 frame bytes: table-15 Huffman packing, ISO 2.4.1.7 side info,
// frame headers, CRC-16, bit-reservoir slot splicing and the depth-K
// emission delay (options.reservoir_depth; 1 = the reference's one-frame
// delay). Byte-for-byte equivalent to the Python path in
// swiftmp3_tpu/io/framing.py (verified by tests/test_native.py).
//
// Behavior parity notes mirror the reference encoder:
//  - CRC-16 covers only the 4 header bytes (MP3Encoder.swift:540-543)
//  - side info padded to 136/256 bits (MP3Encoder.swift:618-624)
//  - one-frame delayed emission + reservoir fillSlot (MP3Encoder.swift:546-565)
//
// Build: g++ -O3 -shared -fPIC -o libmp3render.so frame_render.cpp

#include <cstdint>
#include <cstring>
#include <deque>
#include <utility>
#include <vector>

#include "tables_gen.h"

namespace {

struct BitWriter {
    std::vector<uint8_t> bytes;
    uint64_t acc = 0;
    int nbits = 0;

    void write(uint32_t bits, int count) {
        if (count <= 0) return;
        acc = (acc << count) | (bits & ((1u << count) - 1u));
        nbits += count;
        while (nbits >= 8) {
            nbits -= 8;
            bytes.push_back(static_cast<uint8_t>((acc >> nbits) & 0xFF));
        }
        acc &= (1u << nbits) - 1u;
    }
    void pad_to_byte() {
        if (nbits > 0) {
            bytes.push_back(static_cast<uint8_t>((acc << (8 - nbits)) & 0xFF));
            acc = 0;
            nbits = 0;
        }
    }
};

uint16_t crc_table[256];
bool crc_init_done = false;

void crc_init() {
    if (crc_init_done) return;
    for (int i = 0; i < 256; i++) {
        uint16_t crc = static_cast<uint16_t>(i << 8);
        for (int b = 0; b < 8; b++)
            crc = (crc & 0x8000) ? static_cast<uint16_t>((crc << 1) ^ 0x8005)
                                 : static_cast<uint16_t>(crc << 1);
        crc_table[i] = crc;
    }
    crc_init_done = true;
}

uint16_t crc16_mpeg(const uint8_t* data, size_t n) {
    crc_init();
    uint16_t crc = 0xFFFF;
    for (size_t i = 0; i < n; i++)
        crc = static_cast<uint16_t>((crc << 8) ^ crc_table[((crc >> 8) ^ data[i]) & 0xFF]);
    return crc;
}

struct StreamState {
    // static config
    int channels;
    int sample_rate_index;
    int crc_protected;
    int copyright_bit;
    int original_bit;
    int mode_bits;
    int mode_ext;
    int aligned_mode;  // 1: keep last frame's data at the slot tail
    int iso_crc;       // 1: CRC covers header bytes 3-4 + side info (ISO
                       // 2.4.3.1); 0: 4 header bytes only (reference quirk)
    int scalefac_scale;  // side-info bit: 1 when real_scalefactors is on
                         // (encoder amplifies by 2^sf; ISO factor
                         // 2^(-(1+bit)/2*sf) then cancels exactly)
    int iso_short_blocks;  // 1: emit mixed granules as ISO block_type=2 +
                           // mixed_block_flag (the internal enum's 1 would
                           // signal "start"; options.iso_short_blocks)
    int lsf;   // 0 = MPEG-1, 1 = MPEG-2, 2 = MPEG-2.5 (ISO 13818-3: one
               // granule/frame, 8-bit main_data_begin, 9-bit
               // scalefac_compress, no scfsi, no preflag bit)
    int cap;   // main_data_begin reach: 511 (MPEG-1) or 255 (LSF)
    // reservoir + delay (options.reservoir_depth frames of emission
    // delay; 1 = the reference's one-frame delay). `pending_slot_sum`
    // mirrors the sum of buffered slot sizes for the aligned placement law.
    int depth = 1;
    std::vector<uint8_t> reservoir;
    std::deque<std::pair<std::vector<uint8_t>, int>> buffered;
    int64_t pending_slot_sum = 0;
    // counters
    uint32_t frame_count = 0;
    uint32_t total_bytes = 0;
};

// Pack one granule's big-values region with table 15 (signs appended).
void pack_granule(BitWriter& w, const int8_t* q, int big_values) {
    int n = big_values * 2;
    for (int i = 0; i + 1 < n; i += 2) {
        int x = q[i], y = q[i + 1];
        int ax = x < 0 ? -x : x;
        int ay = y < 0 ? -y : y;
        if (ax > 15) ax = 15;
        if (ay > 15) ay = 15;
        int idx = ax * 16 + ay;
        w.write(TABLE15_CODE[idx], TABLE15_LEN[idx]);
        if (ax) w.write(x < 0 ? 1 : 0, 1);
        if (ay) w.write(y < 0 ? 1 : 0, 1);
    }
}

void build_header(StreamState* s, int bitrate_index, int padding, uint8_t out[4],
                  int mode_ext_override = -1) {
    BitWriter h;
    h.write(0x7FF, 11);
    // version bits: 0b11 MPEG-1, 0b10 MPEG-2 (LSF), 0b00 MPEG-2.5
    h.write(s->lsf == 0 ? 0b11u : (s->lsf == 1 ? 0b10u : 0b00u), 2);
    h.write(0b01, 2);  // Layer III
    h.write(s->crc_protected ? 0 : 1, 1);
    h.write(static_cast<uint32_t>(bitrate_index), 4);
    h.write(static_cast<uint32_t>(s->sample_rate_index), 2);
    h.write(static_cast<uint32_t>(padding), 1);
    h.write(0, 1);  // private
    h.write(static_cast<uint32_t>(s->mode_bits), 2);
    h.write(static_cast<uint32_t>(
        mode_ext_override >= 0 ? mode_ext_override : s->mode_ext), 2);
    h.write(s->copyright_bit ? 1 : 0, 1);
    h.write(s->original_bit ? 1 : 0, 1);
    h.write(0, 2);  // no emphasis
    std::memcpy(out, h.bytes.data(), 4);
}

// Build one frame's [header | optional CRC | side info] bytes (ISO 2.4.1.7).
// Per-granule arrays are indexed at frame f, granule-major (gr*ch + c).
std::vector<uint8_t> build_head_side(
    StreamState* s, int f, int bitrate_index, int padding, int mdb_v,
    const int32_t* part23, const int32_t* big_values, const int32_t* gain,
    const int32_t* block_type, const int32_t* preflag, const int32_t* region0,
    const int32_t* region1, const int32_t* subblock_gain,
    const int32_t* scalefac_compress, const int32_t* table_select,
    const int32_t* count1table, const int32_t* scfsi,
    const int32_t* mode_ext) {
    const int ch = s->channels;
    const int n_gran = s->lsf ? 1 : 2;
    const int G = n_gran * ch;
    // MPEG-1: 17/32 bytes (136/256 bits); LSF: 9/17 (ISO 13818-3 2.4.1.7)
    const int side_bytes = s->lsf ? (ch == 1 ? 9 : 17) : (ch == 1 ? 17 : 32);

    BitWriter si;
    if (s->lsf) {
        // one granule, 8-bit main_data_begin, 1/2 private bits, no scfsi
        si.write(static_cast<uint32_t>(mdb_v > 255 ? 255 : mdb_v), 8);
        si.write(0, ch == 1 ? 1 : 2);
    } else {
        si.write(static_cast<uint32_t>(mdb_v > 511 ? 511 : mdb_v), 9);
        si.write(0, ch == 1 ? 5 : 3);
        for (int c = 0; c < ch; c++)  // scfsi nibble per channel (options.scfsi)
            si.write(scfsi ? static_cast<uint32_t>(scfsi[static_cast<int64_t>(f) * ch + c]) & 15u : 0u, 4);
    }
    for (int gr = 0; gr < n_gran; gr++) {
        for (int c = 0; c < ch; c++) {
            int g = gr * ch + c;
            int64_t o = static_cast<int64_t>(f) * G + g;
            int bt = block_type[o];
            int ws = (bt == 0) ? 0 : 1;
            si.write(static_cast<uint32_t>(part23[o]), 12);
            si.write(static_cast<uint32_t>(big_values[o]), 9);
            si.write(static_cast<uint32_t>(gain[o]), 8);
            // LSF: 9-bit scalefac_compress (ISO 13818-3 six-case slen law)
            si.write(static_cast<uint32_t>(scalefac_compress[o]), s->lsf ? 9 : 4);
            si.write(static_cast<uint32_t>(ws), 1);
            if (ws) {
                // block_type arrives as the internal enum (mixed=1,
                // start=3, stop=4); the ISO encoding for mixed is
                // block_type=2 + mixed_block_flag, and window_sequencing's
                // transitions map START->1 / STOP->3 (twin of
                // frame_results_from_outputs / GoldenBackend)
                int bt_emit = (s->iso_short_blocks && bt == 1) ? 2 : bt;
                if (bt == 3) bt_emit = 1;
                if (bt == 4) bt_emit = 3;
                si.write(static_cast<uint32_t>(bt_emit), 2);
                si.write(bt == 1 ? 1u : 0u, 1);  // mixed_block_flag
                si.write(static_cast<uint32_t>(table_select[o * 3 + 0]), 5);
                si.write(static_cast<uint32_t>(table_select[o * 3 + 1]), 5);
                si.write(static_cast<uint32_t>(subblock_gain[o * 3 + 0]), 3);
                si.write(static_cast<uint32_t>(subblock_gain[o * 3 + 1]), 3);
                si.write(static_cast<uint32_t>(subblock_gain[o * 3 + 2]), 3);
            } else {
                si.write(static_cast<uint32_t>(table_select[o * 3 + 0]), 5);
                si.write(static_cast<uint32_t>(table_select[o * 3 + 1]), 5);
                si.write(static_cast<uint32_t>(table_select[o * 3 + 2]), 5);
                si.write(static_cast<uint32_t>(region0[o]), 4);
                si.write(static_cast<uint32_t>(region1[o]), 3);
            }
            if (!s->lsf)  // no preflag bit in LSF (implicit via compress>=500)
                si.write(static_cast<uint32_t>(preflag[o]), 1);
            si.write(static_cast<uint32_t>(s->scalefac_scale), 1);
            si.write(static_cast<uint32_t>(count1table[o]), 1);
        }
    }
    si.pad_to_byte();
    while (static_cast<int>(si.bytes.size()) < side_bytes) si.bytes.push_back(0);

    uint8_t head[4];
    build_header(s, bitrate_index, padding, head,
                 mode_ext ? static_cast<int>(mode_ext[f]) : -1);
    std::vector<uint8_t> head_side;
    head_side.insert(head_side.end(), head, head + 4);
    if (s->crc_protected) {
        uint16_t crc;
        if (s->iso_crc) {
            // ISO 2.4.3.1: header bytes 3-4 then the side info bits
            std::vector<uint8_t> buf;
            buf.push_back(head[2]);
            buf.push_back(head[3]);
            buf.insert(buf.end(), si.bytes.begin(), si.bytes.end());
            crc = crc16_mpeg(buf.data(), buf.size());
        } else {
            crc = crc16_mpeg(head, 4);  // reference quirk: header only
        }
        head_side.push_back(static_cast<uint8_t>(crc >> 8));
        head_side.push_back(static_cast<uint8_t>(crc & 0xFF));
    }
    head_side.insert(head_side.end(), si.bytes.begin(), si.bytes.end());
    return head_side;
}

}  // namespace

extern "C" {

void* mp3_stream_new(int channels, int sample_rate_index, int crc_protected,
                     int copyright_bit, int original_bit, int mode_bits,
                     int mode_ext, int aligned_mode, int iso_crc,
                     int scalefac_scale, int iso_short_blocks,
                     int reservoir_depth, int lsf) {
    auto* s = new StreamState();
    s->lsf = lsf;
    s->cap = lsf ? 255 : 511;
    s->channels = channels;
    s->sample_rate_index = sample_rate_index;
    s->crc_protected = crc_protected;
    s->copyright_bit = copyright_bit;
    s->original_bit = original_bit;
    s->mode_bits = mode_bits;
    s->mode_ext = mode_ext;
    s->aligned_mode = aligned_mode;
    s->iso_crc = iso_crc;
    s->scalefac_scale = scalefac_scale;
    s->iso_short_blocks = iso_short_blocks;
    s->depth = reservoir_depth < 1 ? 1 : reservoir_depth;
    return s;
}

// Copy min(stream, slot) bytes into `dst`, zero-padding a deficit. In
// aligned mode the last `tail` stream bytes (the newest frame's data) stay
// at the slot TAIL with stuffing zeros before them. At most 511 of the
// newest frame's bytes may precede its header (main_data_begin is 9 bits):
// when tail > 511 the remainder is KEPT in the reservoir and spills into
// the frame's own slot (twin of io/framing.py BitReservoir.fill_slot).
static void fill_slot(StreamState* s, uint8_t* dst, size_t slot_n, size_t tail) {
    const size_t cap = static_cast<size_t>(s->cap);
    size_t keep = (s->aligned_mode && tail > cap) ? tail - cap : 0;
    size_t avail = s->reservoir.size() - keep;
    if (avail >= slot_n) {
        std::memcpy(dst, s->reservoir.data(), slot_n);
        s->reservoir.erase(s->reservoir.begin(), s->reservoir.begin() + slot_n);
        return;
    }
    size_t pad = slot_n - avail;
    size_t t = 0;
    if (s->aligned_mode && tail > 0) {
        t = tail < cap ? tail : cap;
        if (t > avail) t = avail;
    }
    size_t cut = avail - t;
    std::memcpy(dst, s->reservoir.data(), cut);
    std::memset(dst + cut, 0, pad);
    std::memcpy(dst + cut + pad, s->reservoir.data() + cut, t);
    s->reservoir.erase(s->reservoir.begin(), s->reservoir.begin() + avail);
}

void mp3_stream_free(void* p) { delete static_cast<StreamState*>(p); }

uint32_t mp3_frame_count(void* p) { return static_cast<StreamState*>(p)->frame_count; }
uint32_t mp3_total_bytes(void* p) { return static_cast<StreamState*>(p)->total_bytes; }


// Append one frame's main data (aligned: preceded by the placement
// stuffing — the frame's data is tail-aligned against its own header, so
// the gap between the previous frame's data and main_data_begin is zeros),
// buffer its head, and emit the oldest buffered frame once the depth-K
// delay is full. Twin of io/framing.py FrameAssembler.push.
static int64_t push_frame(StreamState* s, const uint8_t* data, size_t hb,
                          int mdb_v, std::vector<uint8_t>&& head_side,
                          int slot_v, uint8_t* out, int64_t out_capacity,
                          int64_t* written, int32_t* frame_sizes_out,
                          int* n_emitted) {
    if (s->aligned_mode) {
        int64_t gap = s->pending_slot_sum - static_cast<int64_t>(s->reservoir.size());
        int64_t stuff = gap - mdb_v;
        if (stuff > 0)
            s->reservoir.insert(s->reservoir.end(), static_cast<size_t>(stuff), 0);
    }
    s->reservoir.insert(s->reservoir.end(), data, data + hb);
    s->buffered.emplace_back(std::move(head_side), slot_v);
    s->pending_slot_sum += slot_v;
    if (static_cast<int>(s->buffered.size()) > s->depth) {
        auto& front = s->buffered.front();
        size_t slot_n = static_cast<size_t>(front.second);
        int64_t frame_size = static_cast<int64_t>(front.first.size()) + front.second;
        if (*written + frame_size > out_capacity) return -1;
        std::memcpy(out + *written, front.first.data(), front.first.size());
        *written += front.first.size();
        fill_slot(s, out + *written, slot_n, 0);
        *written += slot_n;
        s->frame_count += 1;
        s->total_bytes += static_cast<uint32_t>(frame_size);
        s->pending_slot_sum -= front.second;
        frame_sizes_out[(*n_emitted)++] = static_cast<int32_t>(frame_size);
        s->buffered.pop_front();
    }
    return 0;
}

// Render F frames; writes emitted bytes to `out` (caller-sized), per-emitted-
// frame sizes to frame_sizes_out (one entry per emitted frame; count via
// n_emitted_out). Returns total bytes written, or -1 if out_capacity is too
// small.
int64_t mp3_render_frames(void* p, int F,
                          const int32_t* bitrate_index, const int32_t* padding,
                          const int32_t* mdb, const int32_t* slot,
                          const int32_t* part23, const int32_t* big_values,
                          const int32_t* gain, const int32_t* block_type,
                          const int32_t* preflag, const int32_t* region0,
                          const int32_t* region1, const int32_t* subblock_gain,
                          const int32_t* scalefac_compress,
                          const int32_t* table_select, const int32_t* count1table,
                          const int8_t* quantized, uint8_t* out,
                          int64_t out_capacity, int32_t* frame_sizes_out,
                          int32_t* n_emitted_out) {
    auto* s = static_cast<StreamState*>(p);
    const int ch = s->channels;
    const int G = (s->lsf ? 1 : 2) * ch;
    int64_t written = 0;
    int n_emitted = 0;

    for (int f = 0; f < F; f++) {
        // --- main data: all granules packed into one bitstream, pad to byte
        BitWriter md;
        for (int g = 0; g < G; g++) {
            pack_granule(md, quantized + (static_cast<int64_t>(f) * G + g) * 576,
                         big_values[f * G + g]);
        }
        md.pad_to_byte();

        std::vector<uint8_t> head_side = build_head_side(
            s, f, bitrate_index[f], padding[f], mdb[f], part23, big_values,
            gain, block_type, preflag, region0, region1, subblock_gain,
            scalefac_compress, table_select, count1table, nullptr, nullptr);

        if (push_frame(s, md.bytes.data(), md.bytes.size(), mdb[f],
                       std::move(head_side), slot[f], out, out_capacity,
                       &written, frame_sizes_out, &n_emitted) < 0)
            return -1;
    }
    *n_emitted_out = n_emitted;
    return written;
}

// Variant consuming device-packed main_data: the TPU already rendered each
// frame's Huffman byte image (swiftmp3_tpu.ops.dsp.pack_main_data); the host
// only splices reservoir slots and assembles headers/side info.
// main_data: [F][cap] byte images; hb: [F] used byte counts. Returns bytes
// written, -1 on overflow, -2 if any hb exceeds cap (device pack truncated).
int64_t mp3_render_frames_packed(void* p, int F,
                                 const int32_t* bitrate_index, const int32_t* padding,
                                 const int32_t* mdb, const int32_t* slot,
                                 const int32_t* part23, const int32_t* big_values,
                                 const int32_t* gain, const int32_t* block_type,
                                 const int32_t* preflag, const int32_t* region0,
                                 const int32_t* region1, const int32_t* subblock_gain,
                                 const int32_t* scalefac_compress,
                                 const int32_t* table_select, const int32_t* count1table,
                                 const int32_t* scfsi,
                                 const int32_t* mode_ext,
                                 const uint8_t* main_data, int cap,
                                 const int32_t* hb, uint8_t* out,
                                 int64_t out_capacity, int32_t* frame_sizes_out,
                                 int32_t* n_emitted_out) {
    auto* s = static_cast<StreamState*>(p);
    int64_t written = 0;
    int n_emitted = 0;

    for (int f = 0; f < F; f++) {
        if (hb[f] > cap) return -2;
        const uint8_t* md = main_data + static_cast<int64_t>(f) * cap;

        std::vector<uint8_t> head_side = build_head_side(
            s, f, bitrate_index[f], padding[f], mdb[f], part23, big_values,
            gain, block_type, preflag, region0, region1, subblock_gain,
            scalefac_compress, table_select, count1table, scfsi, mode_ext);

        if (push_frame(s, md, static_cast<size_t>(hb[f]), mdb[f],
                       std::move(head_side), slot[f], out, out_capacity,
                       &written, frame_sizes_out, &n_emitted) < 0)
            return -1;
    }
    *n_emitted_out = n_emitted;
    return written;
}

// Emit every still-buffered frame, oldest first (flush; depth-general).
// Per-frame sizes go to frame_sizes_out (caller sizes it to the depth);
// n_emitted_out gets the count. Returns bytes written, -1 on overflow.
int64_t mp3_flush_buffered(void* p, uint8_t* out, int64_t out_capacity,
                           int32_t* frame_sizes_out, int32_t* n_emitted_out) {
    auto* s = static_cast<StreamState*>(p);
    int64_t written = 0;
    int n_emitted = 0;
    while (!s->buffered.empty()) {
        auto& front = s->buffered.front();
        size_t slot_n = static_cast<size_t>(front.second);
        int64_t frame_size = static_cast<int64_t>(front.first.size()) + front.second;
        if (written + frame_size > out_capacity) return -1;
        std::memcpy(out + written, front.first.data(), front.first.size());
        written += front.first.size();
        fill_slot(s, out + written, slot_n, 0);
        written += slot_n;
        s->frame_count += 1;
        s->total_bytes += static_cast<uint32_t>(frame_size);
        s->pending_slot_sum -= front.second;
        frame_sizes_out[n_emitted++] = static_cast<int32_t>(frame_size);
        s->buffered.pop_front();
    }
    *n_emitted_out = n_emitted;
    return written;
}

}  // extern "C"
