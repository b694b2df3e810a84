"""Streaming FrAD decoder engine.

Push-based framed-FrAD -> PCM engine with behavioural parity to the
reference (src/libfrad/decoder.py): FRM_SIGN resync scanning
(decoder.py:82-90), incremental ASFH parsing, CRC-gated RS repair
(decoder.py:63-68), per-frame profile dispatch, Hann overlap-add
crossfade (decoder.py:28-46 — vectorised here via ops/window.py instead
of the reference's per-sample Python loop), mid-stream format-change
detection with `crit` flagging, and force-flush handling.

Intentional divergences from the reference, both documented in SURVEY §5:
* CRC comparison is int-vs-int, so RS repair only runs on frames that
  actually fail CRC (the reference compares int to bytes at
  decoder.py:64-66, which can never be equal, forcing a repair pass on
  every ECC frame).
* the format-change snapshot is a value copy — the reference binds
  `self.info = self.asfh` (decoder.py:96), silently disabling `crit`
  detection after the first frame.
"""

from __future__ import annotations

import numpy as np

from . import models
from .common import FRM_SIGN, MICRO_BATCH_MAX
from .container import ecc
from .container.asfh import ASFH, COMPLETE, FORCE_FLUSH, INCOMPLETE
from .models import COMPACT
from .ops.window import crossfade


class DecodeResult:
    __slots__ = ("pcm", "srate", "frames", "crit")

    def __init__(self, pcm: list[np.ndarray], srate: int, frames: int, crit: bool):
        chunks = [p for p in pcm if p is not None and p.size]
        if chunks:
            self.pcm = np.concatenate(chunks)
        else:
            # channel-consistent empty: concatenates cleanly with any
            # non-empty [T, C] result the same stream produced
            ch = next((p.shape[1] for p in pcm
                       if p is not None and p.ndim == 2), 0)
            self.pcm = np.empty((0, ch))
        self.srate = srate
        self.frames = frames
        self.crit = crit


class Decoder:
    def __init__(self, fix_error: bool = False, exact: bool | None = None):
        """`exact=True` disables the micro-batched drain entirely: every
        frame decodes on the strictly per-frame path, so decoded floats
        are BIT-identical across push granularities — the reference
        decoder's exact chunk-invariance (src/libfrad/decoder.py:28-46)
        — at the cost of one device dispatch per frame. Default False
        (micro-batched; few-ulp grouping noise, PARITY.md 6b); env
        FRAD_TPU_EXACT_DECODE=1 flips the default process-wide."""
        import os

        self.asfh = ASFH()
        self.info: tuple[int, int] = (0, 0)   # (channels, srate) snapshot
        self.buffer = b""
        self.overlap_fragment = np.empty((0, 0), dtype=np.float64)
        self.overlap_prog = 0
        self.fix_error = fix_error
        self.exact = bool(os.environ.get("FRAD_TPU_EXACT_DECODE")) \
            if exact is None else exact
        self.broken_frame = False

    def is_empty(self) -> bool:
        return len(self.buffer) < len(FRM_SIGN) or self.broken_frame

    def get_asfh(self) -> ASFH:
        return self.asfh

    # ------------------------------------------------------------------
    # overlap-add crossfade (reference decoder.py:28-46, vectorised)
    # ------------------------------------------------------------------
    def _overlap(self, frame: np.ndarray, a: ASFH | None = None) -> np.ndarray:
        a = a if a is not None else self.asfh
        olap_len = len(self.overlap_fragment)
        if self.overlap_fragment.size:
            frame, consumed = crossfade(frame, self.overlap_fragment, self.overlap_prog)
            self.overlap_prog += consumed

        if olap_len <= self.overlap_prog:
            self.overlap_fragment = np.empty((0, 0), dtype=np.float64)
            self.overlap_prog = 0
            if a.profile in COMPACT and a.overlap_ratio != 0:
                cut = len(frame) * (a.overlap_ratio - 1) // a.overlap_ratio
                self.overlap_fragment, frame = frame[cut:], frame[:cut]
        return frame

    # ------------------------------------------------------------------
    def _decode_frame_payload(self, frad: bytes, a: ASFH | None = None) -> np.ndarray:
        a = a if a is not None else self.asfh
        if a.profile == 1:
            return models.profile1.digital(frad, a.bit_depth_index, a.channels, a.srate, a.fsize)
        if a.profile == 2:
            return models.profile2.digital(frad, a.bit_depth_index, a.channels, a.srate, a.fsize)
        if a.profile == 4:
            return models.profile4.digital(frad, a.bit_depth_index, a.channels, a.endian)
        return models.profile0.digital(frad, a.bit_depth_index, a.channels, a.endian)

    def _decode_one(self, a: ASFH, frad: bytes) -> np.ndarray:
        """Per-frame path: ECC strip/repair + profile decode + crossfade."""
        if a.ecc:
            repair = self.fix_error and not a.payload_crc_matches(frad)
            frad = ecc.decode(frad, a.ecc_dsize, a.ecc_codesize, repair)
        try:
            pcm = self._decode_frame_payload(frad, a)
        except Exception:
            # corrupt payload beyond repair: emit silence for the frame
            pcm = np.zeros((a.fsize, max(a.channels, 1)))
        return self._overlap(pcm, a)

    def _drain_pending(self, hs: list[ASFH], ps: list[bytes],
                       ret_pcm: list[np.ndarray]) -> None:
        """Decode the deferred frames collected by `process`.

        Runs of >= 2 frames with identical header configuration go to
        the batched cores in few device dispatches (`pipeline._decode_run`,
        the --turbo machinery). The BYTE domain (ECC verify/repair,
        payload handling) is exact on every path; the emitted float PCM
        carries the batched cores' few-ulp f64 reduction-order noise
        relative to the per-frame path (PARITY.md 6b, bounded at 1e-14
        by tests). Mid-crossfade fragments and pathological payloads
        fall back to the per-frame loop. The run-splitting mirrors
        batch_decode's loop (pipeline.py) — change them together.
        """
        if not hs:
            return
        if self.exact:
            # exact chunk-invariant mode: strictly per-frame, matching
            # the reference decoder's bit-identical push invariance
            for h, p in zip(hs, ps):
                ret_pcm.append(self._decode_one(h, p))
            return
        from .ops import policy
        from .parallel import pipeline
        cdt = None if policy.compute_dtype() == "float64" \
            else policy.compute_dtype()

        # split into consecutive uniform-header runs (mixed pushes —
        # e.g. per-frame lossless depth escalation — batch run by run
        # instead of falling back wholesale), then decode each run in
        # power-of-2 groups: an arbitrary batch size would compile a
        # fresh device program (up to seconds each); buckets keep the
        # compiled-shape set tiny and reusable, same as
        # Encoder._micro_batch
        idx = 0
        total = len(hs)
        while idx < total:
            key0 = pipeline._run_key(hs[idx])
            run = 1
            while (idx + run < total
                   and pipeline._run_key(hs[idx + run]) == key0):
                run += 1

            h0 = hs[idx]
            n = h0.fsize
            cut = (n * (h0.overlap_ratio - 1) // h0.overlap_ratio
                   if h0.profile in COMPACT and h0.overlap_ratio > 1 else n)
            frag = self.overlap_fragment
            if (run < 2 or self.overlap_prog != 0
                    or (frag.size and (len(frag) > cut
                                       or frag.shape[1] != h0.channels))):
                # single frame, or a multi-frame progressive crossfade
                # only the per-frame path handles
                ret_pcm.append(self._decode_one(hs[idx], ps[idx]))
                idx += 1
                continue

            end = idx + run
            while idx < end:
                k = 1
                while k * 2 <= min(end - idx, MICRO_BATCH_MAX):
                    k *= 2
                if k < 2 or self.overlap_prog != 0:
                    ret_pcm.append(self._decode_one(hs[idx], ps[idx]))
                    idx += 1
                    continue
                try:
                    out, new_frag = pipeline._decode_run(
                        hs[idx: idx + k], ps[idx: idx + k],
                        fix_error=self.fix_error, compute_dtype=cdt,
                        i16_transfer=False, i24_transfer=False)
                except Exception:
                    # pathological payloads: the per-frame path has the
                    # zero-frame-and-continue semantics (reference
                    # profile1.py:59-64); never fail the whole push
                    for j in range(idx, idx + k):
                        ret_pcm.append(self._decode_one(hs[j], ps[j]))
                    idx += k
                    continue
                frag = self.overlap_fragment
                if frag.size and len(out):
                    ret_pcm.append(np.asarray(
                        pipeline._frag_head(out, frag), dtype=np.float64))
                    ret_pcm.append(np.asarray(out[len(frag):],
                                              dtype=np.float64))
                else:
                    ret_pcm.append(np.asarray(out, dtype=np.float64))
                self.overlap_fragment = np.asarray(new_frag,
                                                   dtype=np.float64)
                self.overlap_prog = 0
                idx += k

    def process(self, stream: bytes) -> DecodeResult:
        self.buffer += stream
        ret_pcm: list[np.ndarray] = []
        frames = 0
        pend_h: list[ASFH] = []
        pend_p: list[bytes] = []

        def drain() -> None:
            nonlocal frames
            frames += len(pend_h)
            self._drain_pending(pend_h, pend_p, ret_pcm)
            pend_h.clear()
            pend_p.clear()

        while True:
            if self.asfh.all_set:
                self.broken_frame = False
                if len(self.buffer) < self.asfh.frmbytes:
                    if len(stream) == 0:
                        self.broken_frame = True
                    break

                frad = self.buffer[:self.asfh.frmbytes]
                self.buffer = self.buffer[self.asfh.frmbytes:]
                # defer the payload decode: consecutive frames batch into
                # one device dispatch at drain points
                pend_h.append(self.asfh.copy())
                pend_p.append(frad)
                self.asfh.clear()
            else:
                if self.asfh.buffer[:len(FRM_SIGN)] != FRM_SIGN:
                    i = self.buffer.find(FRM_SIGN)
                    if i != -1:
                        self.buffer = self.buffer[i:]
                        self.asfh.buffer = self.buffer[:len(FRM_SIGN)]
                        self.buffer = self.buffer[len(FRM_SIGN):]
                    else:
                        self.buffer = self.buffer[-len(FRM_SIGN) + 1:]
                        break
                status, self.buffer = self.asfh.read(self.buffer)
                if status == COMPLETE:
                    if not self.asfh.criteq(self.info):
                        chnl, srate = self.info
                        self.info = self.asfh.snapshot()
                        if srate or chnl:
                            # emit the residual overlap tail of the old
                            # format but KEEP the freshly parsed header so
                            # the pending frame decodes on the next push
                            # (the reference's flush() would clear it and
                            # lose one frame to resync)
                            drain()
                            ret_pcm.append(self._flush_overlap())
                            return DecodeResult(ret_pcm, srate, frames, True)
                elif status == FORCE_FLUSH:
                    drain()
                    ret_pcm.append(self.flush().pcm)
                    break
                else:  # INCOMPLETE
                    break

        drain()
        return DecodeResult(ret_pcm, self.asfh.srate, frames, False)

    def _flush_overlap(self) -> np.ndarray:
        ret = self.overlap_fragment
        if not ret.size and self.info[0]:
            # channel-consistent empty so callers can concatenate
            # process()/flush() results unconditionally
            ret = np.empty((0, self.info[0]), dtype=np.float64)
        self.overlap_fragment = np.empty((0, 0), dtype=np.float64)
        self.overlap_prog = 0
        return ret

    def flush(self) -> DecodeResult:
        ret = self._flush_overlap()
        self.asfh.clear()
        return DecodeResult([ret], self.asfh.srate, 0, False)

    # serialisable engine state (SURVEY §5 checkpoint/resume)
    def state_dict(self) -> dict:
        return {
            "buffer": self.buffer,
            "overlap_fragment": np.asarray(self.overlap_fragment),
            "overlap_prog": self.overlap_prog,
            "info": self.info,
            "fix_error": self.fix_error,
            "exact": self.exact,
        }

    def load_state_dict(self, state: dict) -> None:
        self.buffer = state["buffer"]
        self.overlap_fragment = np.asarray(state["overlap_fragment"])
        self.overlap_prog = state["overlap_prog"]
        self.info = tuple(state["info"])
        self.fix_error = state["fix_error"]
        self.exact = state.get("exact", self.exact)
