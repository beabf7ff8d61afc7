"""Prompt expansion: an API-backed and a local-LLM expander.

Port of `mmpl_tpu/utils/prompt_extend.py` (which imports no JAX; the port
keeps its own copy), with the same system prompts (zh / en, T2V and I2V)
and result record.  `DashScopePromptExpander` posts to the
OpenAI-compatible endpoint with urllib (no dashscope SDK);
`QwenPromptExpander` loads a local Hugging Face model through
`transformers`, imported when it first expands.  Both give back the
original prompt, with `status` False and the error, when expansion
fails: the fallback the serving layer relies on.
"""

from __future__ import annotations

import dataclasses
import json
import urllib.request

import torch

LM_ZH_SYS_PROMPT = (
    "你是一位Prompt优化师，旨在将用户输入改写为优质Prompt，使其更完整、更具表现力，同时不改变原意。"
    "你需要综合用户输入的内容，补充画面细节、光影、风格、镜头语言等要素，"
    "输出一段通顺完整、不超过200字的中文视频描述。")

LM_EN_SYS_PROMPT = (
    "You are a prompt engineer specializing in text-to-video generation. "
    "Rewrite the user's input into a high-quality prompt: keep the original "
    "meaning, add concrete visual details (subjects, motion, lighting, "
    "style, camera language), and output one fluent English paragraph of at "
    "most 200 words. Reply with the rewritten prompt only.")

VL_ZH_SYS_PROMPT = (
    "你是一位Prompt优化师，请结合给定图像与用户输入，生成用于图生视频的完整描述，"
    "补充画面主体、动作、光影与镜头语言，输出不超过200字的中文描述。")

VL_EN_SYS_PROMPT = (
    "You are a prompt engineer for image-to-video generation. Combine the "
    "given image and the user's input into one fluent English prompt of at "
    "most 200 words describing subjects, motion, lighting and camera "
    "language. Reply with the rewritten prompt only.")


@dataclasses.dataclass
class PromptOutput:
    """The result of one expansion."""
    status: bool
    prompt: str
    seed: int = -1
    system_prompt: str = ""
    message: str = ""


class PromptExpander:
    def __init__(self, is_vl: bool = False):
        self.is_vl = is_vl

    def decide_system_prompt(self, tar_lang: str = "zh") -> str:
        if self.is_vl:
            return VL_ZH_SYS_PROMPT if tar_lang == "zh" else VL_EN_SYS_PROMPT
        return LM_ZH_SYS_PROMPT if tar_lang == "zh" else LM_EN_SYS_PROMPT

    def __call__(self, prompt: str, tar_lang: str = "zh", image=None,
                 seed: int = -1) -> PromptOutput:
        system_prompt = self.decide_system_prompt(tar_lang)
        try:
            out = self.extend(prompt, system_prompt, image=image, seed=seed)
            return PromptOutput(True, out, seed, system_prompt)
        except Exception as e:
            return PromptOutput(False, prompt, seed, system_prompt, str(e))

    def extend(self, prompt, system_prompt, image=None, seed=-1) -> str:
        raise NotImplementedError


class DashScopePromptExpander(PromptExpander):
    """API-backed expander over the OpenAI-compatible chat endpoint."""

    def __init__(self, api_key: str,
                 model_name: str = "qwen-plus",
                 base_url: str = ("https://dashscope.aliyuncs.com/"
                                  "compatible-mode/v1"),
                 is_vl: bool = False, timeout: float = 60.0):
        super().__init__(is_vl)
        self.api_key = api_key
        self.model_name = model_name
        self.base_url = base_url.rstrip("/")
        self.timeout = timeout

    def extend(self, prompt, system_prompt, image=None, seed=-1) -> str:
        body = {
            "model": self.model_name,
            "messages": [{"role": "system", "content": system_prompt},
                         {"role": "user", "content": prompt}],
        }
        req = urllib.request.Request(
            f"{self.base_url}/chat/completions",
            data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json",
                     "Authorization": f"Bearer {self.api_key}"})
        with urllib.request.urlopen(req, timeout=self.timeout) as r:
            out = json.loads(r.read())
        return out["choices"][0]["message"]["content"].strip()


class QwenPromptExpander(PromptExpander):
    """Local Qwen2.5(-VL) expander; needs `transformers` and the model's
    weights (a local directory or a name the Hugging Face cache holds)."""

    def __init__(self, model_name: str = "Qwen/Qwen2.5-3B-Instruct",
                 is_vl: bool = False, device: str = "cuda"):
        super().__init__(is_vl)
        self.model_name = model_name
        self.device = device
        self._model = None
        self._tokenizer = None

    def _load(self):
        if self._model is None:
            from transformers import (AutoModelForCausalLM, AutoTokenizer)
            self._tokenizer = AutoTokenizer.from_pretrained(self.model_name)
            self._model = AutoModelForCausalLM.from_pretrained(
                self.model_name).to(self.device).eval()

    def extend(self, prompt, system_prompt, image=None, seed=-1) -> str:
        self._load()
        msgs = [{"role": "system", "content": system_prompt},
                {"role": "user", "content": prompt}]
        text = self._tokenizer.apply_chat_template(
            msgs, tokenize=False, add_generation_prompt=True)
        inputs = self._tokenizer([text], return_tensors="pt").to(self.device)
        with torch.no_grad():
            out = self._model.generate(**inputs, max_new_tokens=512)
        gen = out[0][inputs["input_ids"].shape[1]:]
        return self._tokenizer.decode(gen, skip_special_tokens=True).strip()
