"""The golden granule and frame DSP (`reference`), numpy only."""
