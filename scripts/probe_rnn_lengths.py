"""cuDNN's LSTM and GRU against the CPU's over one long sequence of batch
1 (the served readout's shape), at lengths around the point where cuDNN
refuses the call, and the same sequence in two halves with the state
carried over (how ``reduce/aggr.py`` runs a segment longer than
``RNN_CHUNK``).

    python3 scripts/probe_rnn_lengths.py            # on a CUDA card

Prints one line a cell and length: the largest |card − CPU| over the
outputs, and either error of the two-halves run or cuDNN's error.
"""

import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from tgp_tpu_torch.reduce.aggr import get_aggr  # noqa: E402

LENGTHS = (16_384, 32_767, 32_768, 32_769, 49_152, 65_536)


def main():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(torch.__version__, "cudnn", torch.backends.cudnn.version(),
          torch.cuda.get_device_name(0), flush=True)
    for alias in ("lstm", "gru"):
        cpu = get_aggr(alias, in_channels=128, device="cpu",
                       generator=torch.Generator().manual_seed(0))
        card = get_aggr(alias, in_channels=128, device="cuda")
        card.load_state_dict(cpu.state_dict())
        g = torch.Generator().manual_seed(1)
        for T in LENGTHS:
            x = torch.relu(torch.randn(1, T, 128, generator=g)) * 0.5
            with torch.no_grad():
                ref, _ = cpu.rnn(x)
                h = T // 2
                first, state = card.rnn(x[:, :h].cuda())
                second, _ = card.rnn(x[:, h:].cuda(), state)
                halves = torch.cat([first, second], 1).cpu()
                try:
                    whole = card.rnn(x.cuda())[0].cpu()
                    whole = f"{float((whole - ref).abs().max()):.3e}"
                except RuntimeError as e:
                    whole = f"refused ({str(e).splitlines()[0]})"
            print(f"{alias} T={T}: whole {whole}; two halves "
                  f"{float((halves - ref).abs().max()):.3e}", flush=True)


if __name__ == "__main__":
    main()
