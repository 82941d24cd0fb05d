"""Per-utterance preprocessing for codec training (port of
funcodec_tpu/data/preprocessor.py; numpy, as there).

Behavioral reference: funcodec/datasets/preprocessor.py (CodecPreprocessor
:387-612: optional RIR/noise augmentation, volume/RMS normalization, random
crop or zero-pad to speech_max_length with ppg-aligned cropping) and
Text2AudioPreprocessor :947-1034 (random codec crop + text tokenization).

Fixed-length crops give every training batch one shape.

``rng`` defaults to an unseeded ``RandomState``, as in the JAX package: the
crop starts and augmentation draws are not reproducible unless a seeded one
is passed (and a loader with several threads draws in its own order).
"""

from __future__ import annotations

from typing import Dict, Optional, Union

import numpy as np


class CodecPreprocessor:
    def __init__(
        self,
        train: bool,
        speech_volume_normalize: Optional[float] = None,
        speech_rms_normalize: bool = False,
        speech_name: str = "speech",
        speech_max_length: int = -1,
        frame_shift: int = 160,
        rir_scp: Optional[str] = None,
        rir_apply_prob: float = 1.0,
        noise_scp: Optional[str] = None,
        noise_apply_prob: float = 1.0,
        noise_db_range: str = "3_10",
        rng: Optional[np.random.RandomState] = None,
        **_unused,
    ):
        self.train = train
        self.speech_name = speech_name
        self.speech_volume_normalize = speech_volume_normalize
        self.speech_rms_normalize = speech_rms_normalize
        self.speech_max_length = speech_max_length
        self.frame_shift = frame_shift
        self.rng = rng or np.random.RandomState()
        self.rirs = self._read_list(rir_scp) if train and rir_scp else None
        self.noises = self._read_list(noise_scp) if train and noise_scp else None
        self.rir_apply_prob = rir_apply_prob
        self.noise_apply_prob = noise_apply_prob
        sps = noise_db_range.split("_")
        self.noise_db_low = float(sps[0])
        self.noise_db_high = float(sps[-1])

    @staticmethod
    def _read_list(path):
        out = []
        with open(path, encoding="utf-8") as f:
            for line in f:
                sps = line.strip().split(None, 1)
                out.append(sps[-1])
        return out

    def _augment(self, speech: np.ndarray) -> np.ndarray:
        """RIR convolution + additive noise at a random SNR
        (preprocessor.py:459-543, single-mic subset)."""
        from funcodec_tpu_torch.data.wav_io import read_wav

        power = float(np.mean(speech**2))
        if self.rirs is not None and self.rir_apply_prob >= self.rng.random():
            rir_path = self.rirs[self.rng.randint(len(self.rirs))]
            _, rir = read_wav(rir_path)
            if rir.ndim == 2:
                rir = rir[:, 0]
            dt = np.argmax(np.abs(rir))
            sp = np.convolve(speech, rir, mode="full")[dt : dt + len(speech)]
            power2 = float(np.mean(sp**2))
            if power2 > 0:
                sp = np.sqrt(power / max(power2, 1e-10)) * sp
            speech = sp.astype(np.float32)
        if self.noises is not None and self.noise_apply_prob >= self.rng.random():
            noise_path = self.noises[self.rng.randint(len(self.noises))]
            _, noise = read_wav(noise_path)
            if noise.ndim == 2:
                noise = noise[:, 0]
            if len(noise) >= len(speech):
                start = self.rng.randint(0, len(noise) - len(speech) + 1)
                noise = noise[start : start + len(speech)]
            else:
                noise = np.pad(noise, (0, len(speech) - len(noise)), mode="wrap")
            noise_db = self.rng.uniform(self.noise_db_low, self.noise_db_high)
            noise_power = float(np.mean(noise**2))
            scale = (
                np.sqrt(power / max(noise_power, 1e-10))
                * (10 ** (-noise_db / 20))
            )
            speech = (speech + scale * noise).astype(np.float32)
        return speech

    def __call__(
        self, uid: str, data: Dict[str, Union[str, np.ndarray]]
    ) -> Dict[str, np.ndarray]:
        if self.speech_name in data:
            speech = np.asarray(data[self.speech_name], np.float32)
            if speech.ndim == 2:
                speech = speech[:, 0]

            if self.train and (self.rirs is not None or self.noises is not None):
                ma = float(np.max(np.abs(speech))) if speech.size else 0.0
                if ma > 1.0:
                    speech = speech / ma
                speech = self._augment(speech)

            if self.speech_volume_normalize is not None:
                ma = float(np.max(np.abs(speech)))
                speech = speech * self.speech_volume_normalize / max(ma, 1e-10)
            elif self.speech_rms_normalize:
                volume = float(np.sqrt(np.mean(np.square(speech))))
                speech = speech / (1e-8 + volume)

            if self.speech_max_length > 0:
                max_length = self.speech_max_length
                audio_length = len(speech)
                if audio_length > max_length:
                    start = int(self.rng.randint(0, audio_length - max_length))
                    speech = speech[start : start + max_length]
                    if "ppg" in data:
                        st = int(start / self.frame_shift)
                        dur = int(max_length / self.frame_shift)
                        data["ppg"] = data["ppg"][st : st + dur]
                else:
                    speech = np.pad(speech, (0, max_length - audio_length))
                    if "ppg" in data:
                        pad_len = int(max_length / self.frame_shift) - data["ppg"].shape[0]
                        if data["ppg"].ndim == 2:
                            data["ppg"] = np.pad(data["ppg"], ((0, pad_len), (0, 0)), mode="edge")
                        else:
                            data["ppg"] = np.pad(data["ppg"], (0, pad_len))
            data[self.speech_name] = speech
        return data
