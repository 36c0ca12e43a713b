// Native player VM: decodes and validates .a2m streams at the opcode level.
//
// This is a functional simulator of the 6502 player's steady-state decode
// loop (reference player/main.s:345-456, 1290-1344): the player's control
// flow is entirely stream-steered - every opcode is a 2-byte big-endian
// entry address followed by inline data - so given the opcode address table
// (from the cc65 .dbg symbol table) the stream semantics are fully
// determined without executing 6502 code.  The VM enforces the W5100 2KB
// framing contract the real hardware depends on and reconstructs the screen
// memory images and the audio duty-cycle sequence.
//
// It completes the verification loop the reference's py65-based simulator
// left unfinished (reference simulator/uthernet.py:77-78, 296-297: RECV and
// RX-buffer refill unimplemented).
//
// Build: g++ -O3 -shared -fPIC player_vm.cpp -o libplayer_vm.so

#include <cstdint>
#include <cstring>

namespace {

constexpr int64_t kFrame = 2048;
constexpr int64_t kAckAt = 2044;  // ACK must start here within a 2KB frame

enum Kind : int32_t {
  kUnknown = 0,
  kTick = 1,
  kAck = 2,
  kTerminate = 3,
  kNop = 4,
};

enum Err : int64_t {
  kOk = 0,
  kErrHeader = -1,        // malformed 7-byte header
  kErrUnknownOpcode = -2, // address not in symbol table
  kErrTruncated = -3,     // stream ended mid-opcode
  kErrAckPosition = -4,   // ACK not at a 2KB frame boundary
  kErrAckByte = -5,       // ACK soft-switch byte not 0x54/0x55
  kErrMissingAck = -6,    // opcode other than ACK straddling frame boundary
  kErrPadding = -7,       // nonzero bytes after Terminate
  kErrNotTerminated = -8, // stream ended without Terminate
  kErrStreamLength = -9,  // stream not a whole number of 2KB frames
  kErrDutyOverflow = -10, // more tick opcodes than duty buffer capacity
};

}  // namespace

extern "C" {

// out_counts: [n_ops, n_acks, cycles, err_pos, video_mode, end_pos]
int64_t a2m_decode(const uint8_t* stream, int64_t len,
                   const int32_t* addr_kind, const int32_t* addr_tick,
                   const int32_t* addr_page, uint8_t* main_mem,
                   uint8_t* aux_mem, int32_t* duty, int64_t duty_cap,
                   int64_t* out_counts) {
  int64_t pos = 0;
  int64_t n_ops = 0, n_acks = 0, cycles = 0;
  bool aux_active = false;
  std::memset(main_mem, 0, 8192);
  std::memset(aux_mem, 0, 8192);
  for (int i = 0; i < 6; ++i) out_counts[i] = 0;

  auto fail = [&](Err e) {
    out_counts[0] = n_ops;
    out_counts[1] = n_acks;
    out_counts[2] = cycles;
    out_counts[3] = pos;
    return (int64_t)e;
  };

  if (len % kFrame != 0) return fail(kErrStreamLength);
  if (len < 7) return fail(kErrHeader);
  // Header: 6x 0xff pad + video-mode byte (reference opcodes.py:80-90)
  for (int i = 0; i < 6; ++i) {
    if (stream[i] != 0xff) return fail(kErrHeader);
  }
  int video_mode = stream[6];
  out_counts[4] = video_mode;
  pos = 7;

  for (;;) {
    int64_t in_frame = pos % kFrame;
    bool at_ack_slot = (in_frame == kAckAt);
    if (in_frame > kAckAt) return fail(kErrMissingAck);

    if (pos + 2 > len) return fail(kErrTruncated);
    uint16_t addr = (uint16_t)((stream[pos] << 8) | stream[pos + 1]);
    int32_t kind = addr_kind[addr];
    switch (kind) {
      case kTick: {
        if (at_ack_slot) return fail(kErrMissingAck);
        if (pos + 7 > len) return fail(kErrTruncated);
        // A tick opcode must end by the ACK slot; the player pulls 2KB
        // frames, so an opcode never straddles the boundary
        if (in_frame > kAckAt - 7) return fail(kErrMissingAck);
        uint8_t content = stream[pos + 2];
        uint8_t* mem = aux_active ? aux_mem : main_mem;
        int32_t page = addr_page[addr];  // absolute page 32..63
        for (int i = 0; i < 4; ++i) {
          uint8_t offset = stream[pos + 3 + i];
          mem[((page - 32) << 8) | offset] = content;
        }
        if (n_ops >= duty_cap) return fail(kErrDutyOverflow);
        duty[n_ops] = addr_tick[addr];
        ++n_ops;
        cycles += 73;
        pos += 7;
        break;
      }
      case kAck: {
        if (!at_ack_slot) return fail(kErrAckPosition);
        if (pos + 4 > len) return fail(kErrTruncated);
        uint8_t sw = stream[pos + 2];
        if (sw != 0x54 && sw != 0x55) return fail(kErrAckByte);
        aux_active = (sw == 0x55);
        ++n_acks;
        cycles += 146;  // 2x73-cycle slow path (reference main.s:1290-1344)
        pos += 4;
        break;
      }
      case kTerminate: {
        pos += 2;
        // remainder of the final 2KB frame must be zero padding
        int64_t end = ((pos + kFrame - 1) / kFrame) * kFrame;
        if (end != len) return fail(kErrPadding);
        for (int64_t p = pos; p < end; ++p) {
          if (stream[p] != 0) return fail(kErrPadding);
        }
        out_counts[0] = n_ops;
        out_counts[1] = n_acks;
        out_counts[2] = cycles;
        out_counts[5] = pos;
        return kOk;
      }
      case kNop: {
        pos += 2;
        break;
      }
      default:
        return fail(kErrUnknownOpcode);
    }
    if (pos >= len) return fail(kErrNotTerminated);
  }
}

}  // extern "C"
