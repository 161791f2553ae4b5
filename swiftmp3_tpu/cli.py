"""Command-line encoder: WAV in, MP3 out.

    python -m swiftmp3_tpu input.wav output.mp3 [--bitrate 128] [--vbr]
        [--mode stereo|mono|joint_stereo] [--quality 5] [--crc]
        [--title T --artist A --album AL] [--backend jax|numpy]

Mirrors the reference's file-encode layout: [ID3][Xing/Info][frames].
"""

from __future__ import annotations

import argparse
import sys
import time


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="swiftmp3_tpu", description="Batched JAX MP3 encoder"
    )
    p.add_argument("input", help="input WAV file (PCM16 or float32)")
    p.add_argument("output", help="output MP3 file")
    p.add_argument("--bitrate", type=int, default=128, help="kbps (default 128)")
    p.add_argument("--vbr", action="store_true", help="variable bitrate")
    p.add_argument(
        "--mode",
        choices=["stereo", "mono", "joint_stereo", "auto"],
        default="auto",
        help="channel mode (auto = from WAV channel count)",
    )
    p.add_argument("--quality", type=int, default=5, help="0 best .. 9 smallest")
    p.add_argument("--crc", action="store_true", help="CRC-protect frames")
    p.add_argument(
        "--spec-strict",
        action="store_true",
        help="ISO-conforming output (unit-gain quantization, aligned "
        "reservoir, count1 + per-region tables, real scalefactors, ISO "
        "CRC) instead of byte-exact reference-compatible behavior",
    )
    p.add_argument(
        "--psy",
        action="store_true",
        help="masking-driven scalefactor allocation (implies --spec-strict)",
    )
    p.add_argument(
        "--scfsi",
        action="store_true",
        help="share equal scalefactor groups between granules "
        "(implies --spec-strict)",
    )
    p.add_argument(
        "--hq",
        action="store_true",
        help="high-quality preset: --spec-strict + linbits ESC coding + "
        "scfsi (quality scales with bitrate; see MP3EncoderOptions.hq)",
    )
    p.add_argument(
        "--lowpass",
        type=int,
        default=None,
        metavar="HZ",
        help="zero spectrum above this frequency (subband granularity) so "
        "the bit budget concentrates below — the standard low-bitrate "
        "knob; try 10000-12000 at 64-96 kbps on speech/noisy material",
    )
    p.add_argument(
        "--gapless",
        action="store_true",
        help="gapless playback info: cover the encoder-delay tail at flush "
        "and write the LAME info-tag delay/padding fields "
        "(options.gapless_info)",
    )
    p.add_argument("--title")
    p.add_argument("--artist")
    p.add_argument("--album")
    p.add_argument("--backend", choices=["jax", "numpy"], default="jax")
    p.add_argument("--quiet", action="store_true")
    args = p.parse_args(argv)

    from .options import ID3Tag, MP3EncoderOptions, Mode
    from .streaming import encode_file_sync
    from .encoder import MP3Encoder
    from .utils import read_wav

    pcm, sample_rate, channels = read_wav(args.input)
    if args.mode == "auto":
        mode = Mode.MONO if channels == 1 else Mode.STEREO
    else:
        mode = Mode(args.mode)
    if mode is not Mode.MONO and channels == 1:
        pcm = __import__("numpy").repeat(pcm, 2)  # duplicate mono to stereo
    if mode is Mode.MONO and channels == 2:
        pcm = pcm[0::2]  # left channel

    tag = None
    if args.title or args.artist or args.album:
        tag = ID3Tag(title=args.title, artist=args.artist, album=args.album)

    common = dict(
        sample_rate=sample_rate,
        bitrate_kbps=args.bitrate,
        vbr=args.vbr,
        mode=mode,
        quality=args.quality,
        crc_protected=args.crc,
        id3_tag=tag,
        gapless_info=args.gapless,
        lowpass_hz=args.lowpass,
    )
    if args.hq:
        options = MP3EncoderOptions.hq(psy_scalefactors=args.psy, **common)
    elif args.spec_strict or args.psy or args.scfsi:
        options = MP3EncoderOptions.spec_strict(
            psy_scalefactors=args.psy, scfsi=args.scfsi, **common
        )
    else:
        options = MP3EncoderOptions(**common)
    enc = MP3Encoder(options, backend=args.backend)
    t0 = time.perf_counter()
    encode_file_sync(enc, pcm, args.output)
    dt = time.perf_counter() - t0
    if not args.quiet:
        audio_s = len(pcm) / (sample_rate * options.channels)
        print(
            f"{args.output}: {audio_s:.1f}s audio encoded in {dt:.2f}s "
            f"({audio_s/dt:.0f}x realtime, {options.bitrate_kbps} kbps "
            f"{'VBR' if options.vbr else 'CBR'} {mode.value})",
            file=sys.stderr,
        )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
