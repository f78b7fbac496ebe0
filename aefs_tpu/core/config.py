"""Product constants: operating envelope, UI defaults, factory presets.

Mirrors the reference's constants so a user of the reference finds identical
behavior: engine.py:18-21 (stream format), app.py:6-39 (EFFECT_DEFAULTS),
app.py:41-71 (DEFAULT_PRESETS).  Two effects are new in this build
(BASELINE.md configs 3-4): ``waveshaper`` and ``convreverb``.
"""

SAMPLE_RATE = 48000
BLOCKSIZE = 256
CHANNELS_IN = 1
CHANNELS_OUT = 2

# File mode processes on-device in superblocks under a lax.scan; per-sample
# semantics are independent of this size (see aefs_tpu/ops).  4096 keeps the
# device busy while staying above every feedback lag in the default topologies.
FILE_SUPERBLOCK = 4096

PLOT_FPS = 30          # plot-data pump rate (backend.py:62)
PLOT_QUEUE_BLOCKS = 200  # bounded plot queue depth (backend.py:81-82)
WS_MAX_MESSAGE = 500 * 1024 * 1024  # max WebSocket payload (backend.py:128)

EFFECT_DEFAULTS = {
    "delay": {
        "feedback": 0.5,
        "delay_ms": 300,
        "mix_dry": 0.7,
        "mix_wet": 0.5,
        "offset_ms": 30,
    },
    "reverb": {
        "rt60_s": 1.5,
        "mix_wet": 0.4,
        "mix_dry": 0.8,
        "damp": 0.3,
        "pre_delay_ms": 0.0,
    },
    "gate": {
        "threshold_db": -30.0,
        "attack_ms": 10.0,
        "release_ms": 100.0,
    },
    "spectral": {
        "threshold_db": -45.0,
        "reduction": 0.2,
        "profile_over_db": 6.0,  # margin over a learned noise profile
    },
    "octaver": {
        "semitones": -12.0,
        "mix": 0.5,
    },
    "filter": {
        "filter_type": 0,  # 0=LP 1=HP 2=BP 3=Peak 4=LoShelf 5=HiShelf 6=AllPass
        "cutoff_hz": 1000,
        "q": 0.707,
        "gain_db": 0.0,  # types 3-5 only; 0 dB = exact unity
    },
    # New in this build:
    "chorus": {
        "rate_hz": 0.8,
        "depth_ms": 3.0,
        "base_ms": 12.0,
        "mix": 0.5,
        "spread": 0.25,
    },
    "phaser": {
        "rate_hz": 0.5,
        "min_hz": 200.0,
        "max_hz": 1600.0,
        "mix": 0.5,
        "spread": 0.25,
    },
    "tremolo": {
        "rate_hz": 5.0,
        "depth": 0.5,
        "spread": 0.0,
    },
    "flanger": {
        "rate_hz": 0.3,
        "depth_ms": 2.0,
        "base_ms": 2.5,
        "feedback": 0.6,
        "mix": 0.5,
        "spread": 0.0,
    },
    "wah": {
        "rate_hz": 1.5,
        "min_hz": 350.0,
        "max_hz": 2200.0,
        "res": 3.0,
        "mix": 1.0,
        "mode": 0.0,  # 0=LFO sweep, 1=envelope (auto-wah), blendable
        "sens": 4.0,
        "env_ms": 30.0,
    },
    "ringmod": {
        "carrier_hz": 440.0,
        "mix": 1.0,
        "spread": 0.0,
    },
    "bitcrusher": {
        "bits": 8.0,
        "rate_hz": 8000.0,
        "mix": 1.0,
    },
    "compressor": {
        "threshold_db": -24.0,
        "ratio": 4.0,
        "attack_ms": 10.0,
        "release_ms": 100.0,
        "knee_db": 6.0,
        "makeup_db": 0.0,
    },
    "limiter": {
        "ceiling_db": -1.0,
        "release_ms": 80.0,
        "drive_db": 0.0,
        "lookahead_ms": 5.0,  # static: sets the delay-line topology
    },
    "stereowidth": {
        "width": 1.0,
        "pan": 0.0,
    },
    "waveshaper": {
        "drive": 4.0,
        "shape": 1,  # 0=hard clip, 1=tanh, 2=cubic soft
        "mix": 1.0,
        "out_gain": 1.0,
    },
    "convreverb": {
        "ir_seconds": 2.0,
        "mix_dry": 0.7,
        "mix_wet": 0.4,
    },
}

DEFAULT_PRESETS = {
    "Robot Voice": [
        {"effect_id": "p1", "type": "gate",
         "params": {"threshold_db": -30, "attack_ms": 10, "release_ms": 100}},
        {"effect_id": "p2", "type": "octaver",
         "params": {"semitones": -12, "mix": 1.0}},
        {"effect_id": "p3", "type": "delay",
         "params": {"delay_ms": 120, "feedback": 0.3, "mix_wet": 0.3,
                    "mix_dry": 1.0, "offset_ms": 10}},
    ],
    "Cathedral": [
        {"effect_id": "p4", "type": "reverb",
         "params": {"rt60_s": 4.0, "mix_wet": 0.6, "mix_dry": 0.6,
                    "damp": 0.2, "pre_delay_ms": 20}},
    ],
    "Slapback Echo": [
        {"effect_id": "p5", "type": "delay",
         "params": {"delay_ms": 100, "feedback": 0.0, "mix_wet": 0.5,
                    "mix_dry": 1.0, "offset_ms": 0}},
    ],
    "Clean Noise Removal": [
        {"effect_id": "p6", "type": "spectral",
         "params": {"threshold_db": -50, "reduction": 0.1}},
        {"effect_id": "p7", "type": "gate",
         "params": {"threshold_db": -40, "attack_ms": 5, "release_ms": 200}},
    ],
    "Guitar Filter": [
        {"effect_id": "g1", "type": "filter",
         "params": {"filter_type": 2, "cutoff_hz": 800, "q": 0.8}},
        {"effect_id": "g2", "type": "reverb",
         "params": {"mix_wet": 0.2, "rt60_s": 1.0}},
    ],
    "Rain Delay": [
        {"effect_id": "rd1", "type": "delay",
         "params": {"feedback": 0.2, "delay_ms": 375, "mix_dry": 1,
                    "mix_wet": 1, "offset_ms": 0}},
        {"effect_id": "rd2", "type": "reverb",
         "params": {"rt60_s": 2.1, "mix_wet": 0.4, "mix_dry": 0.8,
                    "damp": 0.05, "pre_delay_ms": 0}},
    ],
    # New-effect showcases:
    "Crunch": [
        {"effect_id": "w1", "type": "waveshaper",
         "params": {"drive": 8.0, "shape": 1, "mix": 1.0, "out_gain": 0.7}},
        {"effect_id": "w2", "type": "filter",
         "params": {"filter_type": 0, "cutoff_hz": 3500, "q": 0.9}},
    ],
    "Concert Hall (Convolution)": [
        {"effect_id": "cv1", "type": "convreverb",
         "params": {"ir_seconds": 2.5, "mix_dry": 0.7, "mix_wet": 0.5}},
    ],
    "Glue Bus": [
        {"effect_id": "cp1", "type": "compressor",
         "params": {"threshold_db": -18.0, "ratio": 3.0, "attack_ms": 30.0,
                    "release_ms": 200.0, "knee_db": 6.0, "makeup_db": 3.0}},
    ],
    "Jet Flanger": [
        # Regenerative flanger: the feedback path is what makes the
        # resonant jet (models/flanger.py; the feed-forward comb alone
        # is the chorus at a short base).
        {"effect_id": "jf1", "type": "flanger",
         "params": {"rate_hz": 0.25, "depth_ms": 2.0, "base_ms": 3.0,
                    "feedback": 0.7, "mix": 0.5, "spread": 0.0}},
    ],
    "Master Bus": [
        # Glue compression into a -1 dB brickwall ceiling.
        {"effect_id": "mb1", "type": "compressor",
         "params": {"threshold_db": -18.0, "ratio": 2.5, "attack_ms": 25.0,
                    "release_ms": 180.0, "knee_db": 6.0, "makeup_db": 3.0}},
        {"effect_id": "mb2", "type": "stereowidth",
         "params": {"width": 1.25, "pan": 0.0}},
        {"effect_id": "mb3", "type": "limiter",
         "params": {"ceiling_db": -1.0, "release_ms": 80.0, "drive_db": 3.0,
                    "lookahead_ms": 5.0}},
    ],
    "Funky Talk": [
        # Envelope auto-wah into a touch of slap delay.
        {"effect_id": "fw1", "type": "wah",
         "params": {"mode": 1.0, "sens": 8.0, "env_ms": 25.0, "res": 4.0,
                    "min_hz": 300.0, "max_hz": 2500.0, "mix": 1.0,
                    "rate_hz": 1.5}},
        {"effect_id": "fw2", "type": "delay",
         "params": {"delay_ms": 110, "feedback": 0.15, "mix_wet": 0.25,
                    "mix_dry": 1.0, "offset_ms": 0}},
    ],
    "8-Bit Arcade": [
        {"effect_id": "ba1", "type": "bitcrusher",
         "params": {"bits": 6.0, "rate_hz": 11025.0, "mix": 1.0}},
        {"effect_id": "ba2", "type": "ringmod",
         "params": {"carrier_hz": 55.0, "mix": 0.35, "spread": 0.25}},
    ],
    "Psychedelic Sweep": [
        {"effect_id": "ps1", "type": "phaser",
         "params": {"rate_hz": 0.3, "min_hz": 150.0, "max_hz": 3000.0,
                    "mix": 0.5, "spread": 0.3}},
        {"effect_id": "ps2", "type": "delay",
         "params": {"delay_ms": 400, "feedback": 0.35, "mix_dry": 1.0,
                    "mix_wet": 0.35, "offset_ms": 20}},
    ],
    "Lush Chorus": [
        {"effect_id": "lc1", "type": "chorus",
         "params": {"rate_hz": 0.6, "depth_ms": 4.0, "base_ms": 14.0,
                    "mix": 0.5, "spread": 0.25}},
        {"effect_id": "lc2", "type": "reverb",
         "params": {"rt60_s": 1.2, "damp": 0.25, "pre_delay_ms": 10,
                    "mix_dry": 0.8, "mix_wet": 0.25}},
    ],
    "Broadcast Voice": [
        {"effect_id": "bv1", "type": "gate",
         "params": {"threshold_db": -50.0, "attack_ms": 5.0,
                    "release_ms": 150.0}},
        {"effect_id": "bv2", "type": "compressor",
         "params": {"threshold_db": -20.0, "ratio": 4.0, "attack_ms": 8.0,
                    "release_ms": 120.0, "knee_db": 6.0, "makeup_db": 4.0}},
        {"effect_id": "bv3", "type": "filter",  # presence shelf
         "params": {"filter_type": 5, "cutoff_hz": 4500.0, "q": 0.707,
                    "gain_db": 4.0}},
    ],
}

def _mb_comp(eid, thr, ratio, attack, release):
    return {"effect_id": eid, "type": "compressor",
            "params": {"threshold_db": thr, "ratio": ratio,
                       "attack_ms": attack, "release_ms": release,
                       "knee_db": 6.0, "makeup_db": 0.0}}


def _multiband_master():
    # Shipped EXPANDED (a plain parallel config) so the SPA's existing
    # parallel-branch cards render it; the compact authoring form is the
    # `multiband` type (core/multiband.py), which build_chain expands to
    # exactly this.
    from aefs_tpu.core.multiband import expand_multiband

    mb = expand_multiband({
        "effect_id": "mm", "type": "multiband",
        "crossover_hz": [150.0, 2000.0],
        "branches": [
            [_mb_comp("mmc0", -20.0, 5.0, 20.0, 250.0)],   # tame lows
            [_mb_comp("mmc1", -22.0, 2.5, 10.0, 150.0)],   # glue mids
            [_mb_comp("mmc2", -26.0, 3.0, 2.0, 80.0)],     # de-harsh highs
        ],
    })
    return [
        mb,
        {"effect_id": "mmw", "type": "stereowidth",
         "params": {"width": 1.2, "pan": 0.0}},
        {"effect_id": "mml", "type": "limiter",
         "params": {"ceiling_db": -1.0, "release_ms": 100.0,
                    "drive_db": 2.0, "lookahead_ms": 5.0}},
    ]


DEFAULT_PRESETS["Multiband Master"] = _multiband_master()

# Params that are static topology (rebuild the chain on change) rather
# than live smoothed targets — the UI sends build_chain instead of
# update_param for these.
STATIC_UI_PARAMS = {"convreverb": ["ir_seconds"],
                    "limiter": ["lookahead_ms"]}

# UI slider specs: (param, label, min, max, step) per effect type
# (app.py:84-122 plus the two new effects).
UI_CONTROLS = {
    "delay": [
        ("feedback", "Feedback", 0, 0.95, 0.01),
        ("delay_ms", "Delay time (ms)", 50, 1000, 1),
        ("mix_dry", "Dry mix", 0, 1, 0.01),
        ("mix_wet", "Wet mix", 0, 1, 0.01),
        ("offset_ms", "Stereo offset", -1000, 1000, 1),
    ],
    "reverb": [
        ("rt60_s", "60dB decay time (s)", 0.1, 10.0, 0.1),
        ("mix_dry", "Dry mix", 0, 1, 0.01),
        ("mix_wet", "Wet mix", 0, 1, 0.01),
        ("damp", "Damping", 0, 0.95, 0.01),
        ("pre_delay_ms", "Pre-delay (ms)", 0, 100, 1),
    ],
    "gate": [
        ("threshold_db", "Threshold (dB)", -60, 0, 1),
        ("attack_ms", "Attack (ms)", 1, 500, 1),
        ("release_ms", "Release (ms)", 10, 1000, 10),
    ],
    "spectral": [
        ("threshold_db", "Noise Threshold (dB)", -80, 0, 1),
        ("reduction", "Noise Floor (0=Silence, 1=Orig)", 0.0, 1.0, 0.05),
        ("profile_over_db", "Profile Margin (dB, learned)", 0.0, 24.0, 0.5),
    ],
    "octaver": [
        ("semitones", "Pitch Shift (Semitones)", -24, 24, 1),
        ("mix", "Mix (0=Dry, 1=Wet)", 0.0, 1.0, 0.05),
    ],
    "filter": [
        ("filter_type",
         "Type (0=Low, 1=High, 2=Band, 3=Peak, 4=LoShelf, 5=HiShelf, 6=AllPass)",
         0, 6, 1),
        ("cutoff_hz", "Frequency (Hz)", 20, 10000, 10),
        ("q", "Resonance (Q)", 0.1, 5.0, 0.1),
        ("gain_db", "Gain (dB, types 3-5)", -24, 24, 0.5),
    ],
    "chorus": [
        ("rate_hz", "Rate (Hz)", 0.05, 10.0, 0.05),
        ("depth_ms", "Depth (ms)", 0.0, 10.0, 0.1),
        ("base_ms", "Base delay (ms)", 1.0, 40.0, 0.5),
        ("mix", "Mix", 0.0, 1.0, 0.01),
        ("spread", "Stereo spread (cycles)", 0.0, 0.5, 0.01),
    ],
    "phaser": [
        ("rate_hz", "Rate (Hz)", 0.05, 10.0, 0.05),
        ("min_hz", "Sweep floor (Hz)", 50, 2000, 10),
        ("max_hz", "Sweep ceiling (Hz)", 100, 8000, 10),
        ("mix", "Mix (0.5=classic notches)", 0.0, 1.0, 0.01),
        ("spread", "Stereo spread (cycles)", 0.0, 0.5, 0.01),
    ],
    "tremolo": [
        ("rate_hz", "Rate (Hz)", 0.05, 20.0, 0.05),
        ("depth", "Depth", 0.0, 1.0, 0.02),
        ("spread", "Stereo spread (0.5=auto-pan)", 0.0, 0.5, 0.01),
    ],
    "flanger": [
        ("rate_hz", "Rate (Hz)", 0.05, 5.0, 0.05),
        ("depth_ms", "Depth (ms)", 0.0, 5.0, 0.1),
        ("base_ms", "Base delay (ms)", 0.5, 10.0, 0.25),
        ("feedback", "Regeneration", -0.9, 0.9, 0.02),
        ("mix", "Mix", 0.0, 1.0, 0.01),
        ("spread", "Stereo spread (cycles)", 0.0, 0.5, 0.01),
    ],
    "wah": [
        ("rate_hz", "LFO rate (Hz)", 0.05, 8.0, 0.05),
        ("min_hz", "Sweep floor (Hz)", 100, 1000, 10),
        ("max_hz", "Sweep ceiling (Hz)", 300, 4000, 10),
        ("res", "Resonance (Q)", 0.5, 8.0, 0.1),
        ("mix", "Mix", 0.0, 1.0, 0.01),
        ("mode", "Mode (0=LFO, 1=Envelope)", 0.0, 1.0, 0.05),
        ("sens", "Envelope sensitivity", 0.5, 20.0, 0.25),
        ("env_ms", "Envelope speed (ms)", 5, 200, 1),
    ],
    "ringmod": [
        ("carrier_hz", "Carrier (Hz)", 0.5, 5000, 0.5),
        ("mix", "Mix", 0.0, 1.0, 0.01),
        ("spread", "Stereo spread (cycles)", 0.0, 0.5, 0.01),
    ],
    "bitcrusher": [
        ("bits", "Bit depth", 1, 16, 1),
        ("rate_hz", "Sample rate (Hz)", 300, 48000, 100),
        ("mix", "Mix", 0.0, 1.0, 0.01),
    ],
    "compressor": [
        ("threshold_db", "Threshold (dB)", -60, 0, 1),
        ("ratio", "Ratio", 1, 20, 0.5),
        ("attack_ms", "Attack (ms)", 0.1, 500, 0.1),
        ("release_ms", "Release (ms)", 10, 1000, 10),
        ("knee_db", "Knee width (dB)", 0, 24, 1),
        ("makeup_db", "Makeup gain (dB)", -12, 24, 0.5),
    ],
    "limiter": [
        ("ceiling_db", "Ceiling (dB)", -24, 0, 0.25),
        ("release_ms", "Release (ms)", 10, 1000, 10),
        ("drive_db", "Input drive (dB)", -12, 24, 0.25),
        ("lookahead_ms", "Look-ahead (ms)", 1, 10, 0.5),
    ],
    "stereowidth": [
        ("width", "Width (0=mono, 1=unity, 2=wide)", 0.0, 2.0, 0.02),
        ("pan", "Balance (L -1 .. +1 R)", -1.0, 1.0, 0.02),
    ],
    "waveshaper": [
        ("drive", "Drive", 1.0, 50.0, 0.5),
        ("shape", "Shape (0=Hard, 1=Tanh, 2=Soft)", 0, 2, 1),
        ("mix", "Mix", 0.0, 1.0, 0.01),
        ("out_gain", "Output gain", 0.0, 2.0, 0.01),
    ],
    "convreverb": [
        ("ir_seconds", "IR length (s)", 0.25, 5.0, 0.25),
        ("mix_dry", "Dry mix", 0, 1, 0.01),
        ("mix_wet", "Wet mix", 0, 1, 0.01),
    ],
}
