"""Single-source, typed runtime configuration.

Replaces the reference's ``PC/src/config.json`` + ``build_config.py`` codegen
pipeline (reference: ``PC/src/build_config.py:16-72``), which baked constants
into compile-time ``#define``s and forced a full C rebuild on any change.

Here the config is a frozen (hashable) dataclass: static shapes enter jit via
specialization — changing the grid resolution or mic count triggers a JAX
retrace, not a C rebuild.  The hard-coded 122-entry dead-microphone list from
``PC/src/api.c:835-851`` and the ``unused_mics.npy`` side-channel from
``PC/src/directions.pyx:61-65`` both become explicit config fields.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Tuple

# The reference zeroes these channels in every `get_data` call because the
# physical arrays had dead microphones (PC/src/api.c:835-851).  Kept verbatim
# so replay captures from the reference hardware reproduce bit-identically.
REFERENCE_DEAD_MICS: Tuple[int, ...] = (
    0, 1,
    4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22,
    23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40,
    41, 42,
    47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58, 59, 60, 61, 62, 63, 64,
    83, 84, 85, 86, 87, 88, 89, 90, 91, 92, 93, 94, 95, 96,
    98, 99, 100, 101, 102, 103, 104, 105, 106, 107, 108, 109, 110, 111, 112,
    135,
    137,
    143,
    145, 146, 147, 148, 149, 150, 151, 152, 153, 154,
    159,
    160,
    162, 163, 164, 165, 166, 167,
    169,
    175,
    184,
    192, 193, 194, 195, 196, 197, 198, 199, 200, 201,
)


# The precision tiers of the heatmap path, as Config overrides.  On an
# H100 "highest" runs full f32 products, "high" runs f32 operands as TF32
# and "bf16" keeps bf16 steering tables (bf16 products on the time-domain
# path, TF32 planes built from the bf16 taps on the frequency-domain one).
TIERS = {
    "highest": dict(matmul_precision="highest"),
    "high": dict(matmul_precision="high"),
    "bf16": dict(matmul_precision="default", matmul_dtype="bfloat16"),
}


@dataclasses.dataclass(frozen=True)
class Config:
    """All tunables of the acoustic-camera pipeline.

    Field defaults mirror ``PC/src/config.json:1-67`` exactly, so a default
    ``Config()`` describes the same system the reference ships.
    """

    # --- array geometry (config.json "general") ---
    n_microphones: int = 256          # N_MICROPHONES
    n_samples: int = 256              # N_SAMPLES per frame
    n_taps: int = 8                   # N_TAPS (FIR fractional-delay filter)
    columns: int = 8                  # COLUMNS per array
    rows: int = 8                     # ROWS per array
    max_res_x: int = 57               # MAX_RES_X (azimuth grid)
    max_res_y: int = 32               # MAX_RES_Y (elevation grid)
    z_scan: float = 1.0               # Z — distance to scanning window [m]
    max_angle: float = 70.0           # MAX_ANGLE [deg] (angle-grid delay model)
    view_angle: float = 59.0          # VIEW_ANGLE [deg] (cartesian window)
    sample_rate: float = 48828.0      # SAMPLE_RATE [Hz]
    element_distance: float = 0.02    # ELEMENT_DISTANCE [m]
    active_arrays: int = 3            # ACTIVE_ARRAYS
    skip_n_mics: int = 1              # SKIP_N_MICS (decimation mode: 1=all,
                                      # 2=every 2nd, 3=every 3rd, 4=every 4th)
    propagation_speed: float = 340.0  # PROPAGATION_SPEED [m/s]
    # Aspect ratio of the scanning window.  directions.pyx:101 hard-codes
    # 16/9 inside calculate_delays() (the config.json ASPECT_RATIO=4/3 is
    # only used by the viewer); default matches the delay model.
    aspect_ratio: float = 16.0 / 9.0

    # Total number of physical array slots the mic-index plane is laid out
    # for.  directions.pyx:16 hard-codes `_ACTIVE_MICS = 4` (4 daisy-chained
    # 8x8 boards) independent of ACTIVE_ARRAYS.
    array_slots: int = 4

    # --- FFT-stack geometry (PC/application/realtime_scripts) -------------
    # The FFT-domain backend carries its own mic model
    # (realtime_scripts/calc_r_prime.py:7,17-20): the array plane is shifted
    # down by the camera mount offset and the boards are spread by a gap.
    camera_offset: float = 0.0        # camera_offset [m] (calc_r_prime.py:7)
    array_separation: float = 0.0     # ARRAY_SEPARATION [m] (config.py:19)
    # Which mic model feeds the FFT-domain phase tensor: "main" (the
    # directions.pyx geometry, round-1 behaviour) or "fft" (the
    # calc_r_prime.py geometry with camera_offset/array_separation).
    fft_mic_model: str = "main"
    # rfft band limits [Hz] for the FFT-domain backend
    # (threshold_freq_lower/upper, realtime_scripts/config.py:47-48).
    freq_band_low: float = 0.0
    freq_band_high: float = -1.0      # -1 => Nyquist

    # --- transport (config.json "general") ---
    udp_ip: str = "10.0.0.1"          # UDP_IP
    udp_replay_ip: str = "127.0.0.1"  # UDP_REPLAY_IP
    udp_port: int = 21844             # UDP_PORT
    fpga_protocol_version: int = 2    # FPGA_PROTOCOL_VERSION

    # --- normalization / audio (config.json "c") ---
    norm_factor: float = 16777216.0   # NORM_FACTOR = 2**24 (int32 -> float)
    norm_factor_sound: float = 2000000.0
    miso_power: int = 15
    mic_gain: float = 128.0           # MIC_GAIN (playback volume)

    # --- UI (config.json "general") ---
    window_width: int = 720           # APPLICATION_WINDOW_WIDTH
    window_height: int = 480          # APPLICATION_WINDOW_HEIGHT
    camera_source: int = 2            # CAMERA_SOURCE
    flip_image: bool = True           # FLIP_IMAGE
    application_name: str = "zybo-rt-tpu"

    # --- dead/disabled channels (replaces api.c:835-851 + unused_mics.npy) ---
    disabled_mics: Tuple[int, ...] = ()
    # Mic indices excluded *before* geometry (the unused_mics.npy deadmap in
    # directions.pyx:61-65 — indices there are offset by +64 at load).
    unused_mics: Tuple[int, ...] = ()

    # --- compute ---
    dtype: str = "float32"            # accumulation dtype on device
    matmul_dtype: str = "float32"     # steering-table (W) dtype
    # lax.Precision of the steering contractions: "highest" = full f32
    # products (the bit-level exactness gates); "high"/"default" let the
    # GPU run f32 operands as TF32.  See TIERS for the named tiers.
    matmul_precision: str = "highest"

    # ------------------------------------------------------------------
    @property
    def buffer_length(self) -> int:
        """BUFFER_LENGTH = N_SAMPLES * N_MICROPHONES (config.json:31)."""
        return self.n_samples * self.n_microphones

    @property
    def n_directions(self) -> int:
        return self.max_res_x * self.max_res_y

    @property
    def frame_seconds(self) -> float:
        """One frame of audio = N_SAMPLES / SAMPLE_RATE (~5.24 ms)."""
        return self.n_samples / self.sample_rate

    @property
    def mics_per_array(self) -> int:
        return self.rows * self.columns

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)

    # --- (de)serialization ----------------------------------------------
    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_json(cls, text: str) -> "Config":
        d = json.loads(text)
        for k in ("disabled_mics", "unused_mics"):
            if k in d:
                d[k] = tuple(d[k])
        return cls(**d)

    @classmethod
    def reference(cls) -> "Config":
        """The exact hardware config of the reference system, including its
        dead-microphone list (api.c:835-851)."""
        return cls(disabled_mics=REFERENCE_DEAD_MICS)

    @classmethod
    def fft_reference(cls) -> "Config":
        """The FFT-domain backend's own (divergent) config, as the web app
        ships it (``PC/application/realtime_scripts/config.py:6-49``):
        13x13 grid, 68 deg window, c = 343 m/s, 4 active arrays, 64 taps,
        0-18 kHz band, camera offset 0.11 m, zero array separation, mode 1
        (all mics).  Use this to reproduce web backend-3 output exactly."""
        return cls(
            n_taps=64,                 # N_TAPS (config.py:8)
            max_res_x=13,              # MAX_RES_X (config.py:12)
            max_res_y=13,              # MAX_RES_Y (config.py:13)
            max_angle=68.0,            # MAX_ANGLE (config.py:15)
            view_angle=68.0,           # VIEW_ANGLE (config.py:16)
            propagation_speed=343.0,   # PROPAGATION_SPEED (config.py:22)
            active_arrays=4,           # ACTIVE_ARRAYS (config.py:20)
            array_slots=4,
            camera_offset=0.11,        # calc_r_prime.py:7
            array_separation=0.0,      # ARRAY_SEPARATION (config.py:19)
            fft_mic_model="fft",
            freq_band_low=0.0,         # threshold_freq_lower (config.py:47)
            freq_band_high=18000.0,    # threshold_freq_upper (config.py:48)
        )

    @classmethod
    def northstar(cls) -> "Config":
        """The benchmark config: one 8x8 board (64 ch), 65x65 steering grid
        (see BASELINE.json)."""
        return cls(
            n_microphones=64,
            active_arrays=1,
            array_slots=1,
            max_res_x=65,
            max_res_y=65,
            aspect_ratio=1.0,
        )

    @classmethod
    def tiny(cls) -> "Config":
        """Small config for fast unit tests."""
        return cls(
            n_microphones=16,
            rows=4,
            columns=4,
            n_samples=64,
            active_arrays=1,
            array_slots=1,
            max_res_x=9,
            max_res_y=7,
        )


DEFAULT = Config()
