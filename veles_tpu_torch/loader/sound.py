"""Sound file loaders.

The port of ``veles_tpu/loader/sound.py`` (reference
``veles/loader/libsndfile_loader.py``): WAV decoding with the stdlib
``wave`` module only (16/8/32-bit PCM, mono or stereo), with a hook
(:meth:`SoundDecoderMixin.decode_file`) where another decoder slots in.

The decoded waveforms are windowed into fixed-length frames
(``window_size`` samples, ``window_stride`` hop), optionally averaged to
mono, and served through the device-resident full-batch loader.
"""

import logging
import wave

import numpy

from veles_tpu_torch.loader.base import TEST, VALID, TRAIN, register_loader
from veles_tpu_torch.loader.file_loader import (AutoLabelMixin,
                                                FileScannerMixin)
from veles_tpu_torch.loader.fullbatch import FullBatchLoader


class SoundDecoderMixin:
    """WAV decoding (reference ``SndFileMixin``,
    ``libsndfile_loader.py:46-91``)."""

    @staticmethod
    def decode_file(path):
        """-> dict(data (frames, channels) float32 in [-1, 1],
        sampling_rate, samples, channels, name)."""
        with wave.open(path, "rb") as snd:
            channels = snd.getnchannels()
            if channels > 2:
                raise ValueError(
                    "%s has %d channels; only mono or stereo are allowed"
                    % (path, channels))
            width = snd.getsampwidth()
            frames = snd.getnframes()
            raw = snd.readframes(frames)
            rate = snd.getframerate()
        if width == 2:
            data = numpy.frombuffer(raw, numpy.int16) / 32768.0
        elif width == 4:
            data = numpy.frombuffer(raw, numpy.int32) / 2147483648.0
        elif width == 1:  # unsigned 8-bit PCM
            data = (numpy.frombuffer(raw, numpy.uint8).astype(
                numpy.float32) - 128.0) / 128.0
        else:
            raise ValueError("%s: unsupported sample width %d"
                             % (path, width))
        # derive frames from the DECODED length: a truncated data chunk
        # must not crash an opaque reshape against the header count
        data = data.astype(numpy.float32).reshape(-1, channels)
        if len(data) != frames:
            logging.getLogger("SoundDecoder").warning(
                "%s: header says %d frames, decoded %d (truncated?)",
                path, frames, len(data))
        return {"data": data, "sampling_rate": rate,
                "samples": len(data), "channels": channels, "name": path}


@register_loader("sound_file")
class SoundFileLoader(SoundDecoderMixin, FileScannerMixin,
                      FullBatchLoader):
    """Windowed waveforms from directory scans, label =
    :meth:`get_label_from_filename` (reference ``SndFileLoaderBase``,
    ``libsndfile_loader.py:93-105``)."""

    hide_from_registry = True

    def __init__(self, workflow, **kwargs):
        self.window_size = int(kwargs.pop("window_size", 1024))
        self.window_stride = int(kwargs.pop("window_stride",
                                            self.window_size))
        self.mono = kwargs.pop("mono", True)
        self._expected_channels = None
        FileScannerMixin.__init__(
            self, **{k: kwargs.pop(k) for k in
                     ("test_paths", "validation_paths", "train_paths")
                     if k in kwargs})
        FullBatchLoader.__init__(self, workflow, **kwargs)

    def is_valid_filename(self, filename):
        return filename.lower().endswith(".wav")

    def get_label_from_filename(self, filename):
        raise NotImplementedError

    def _windows(self, path):
        """Window over FRAMES (not interleaved samples): a stereo window
        of ``window_size`` covers window_size time steps and its feature
        layout is channel-consistent across windows regardless of
        stride parity."""
        decoded = self.decode_file(path)
        data = decoded["data"]  # (frames, channels)
        if self.mono and decoded["channels"] > 1:
            data = data.mean(axis=1, keepdims=True)
        elif not self.mono:
            # mixed mono/stereo datasets would produce ragged windows and
            # die in numpy.stack with no filename — fail HERE with one
            if self._expected_channels is None:
                self._expected_channels = data.shape[1]
            elif data.shape[1] != self._expected_channels:
                raise ValueError(
                    "%s has %d channels but the dataset started with %d "
                    "(use mono=True to mix)" % (
                        path, data.shape[1], self._expected_channels))
        frames = len(data)
        out = []
        for start in range(0, frames - self.window_size + 1,
                           self.window_stride):
            out.append(data[start:start + self.window_size].reshape(-1))
        if not out and frames:  # short clip: one zero-padded window
            padded = numpy.zeros((self.window_size, data.shape[1]),
                                 numpy.float32)
            padded[:frames] = data
            out.append(padded.reshape(-1))
        return out

    def load_data(self):
        rows, labels, lengths = [], [], []
        for klass in (TEST, VALID, TRAIN):
            paths = (self.test_paths, self.validation_paths,
                     self.train_paths)[klass]
            count = 0
            for path in self.collect_keys(paths):
                label = self.get_label_from_filename(path)
                for window in self._windows(path):
                    rows.append(window)
                    labels.append(label)
                    count += 1
            lengths.append(count)
        if not rows:
            raise ValueError("%s found no audio windows" % self.name)
        self._provided_data = numpy.stack(rows)
        self._provided_labels = labels
        self._provided_lengths = lengths
        super().load_data()


@register_loader("auto_label_sound_file")
class AutoLabelSoundFileLoader(AutoLabelMixin, SoundFileLoader):
    """Sound files labeled by path regexp, default = parent directory
    (the FLAC/WAV auto-label combination the reference assembled from
    its mixins)."""

    def __init__(self, workflow, **kwargs):
        AutoLabelMixin.__init__(
            self, **{k: kwargs.pop(k) for k in ("label_regexp",)
                     if k in kwargs})
        SoundFileLoader.__init__(self, workflow, **kwargs)
