"""Character pools of the stage-3 data generator (the port's own copy).

``KANJI_COMMON`` as in ``findtextcenternet_tpu/factory/charpools.py``: the
common-kanji class of :func:`.transformer_data._jp_pools`. The rest of that
module (class weighting, kanji tiers, wordlists) serves the page factory,
which is not ported.
"""

# ~440 high-frequency kanji (kyoiku grades 1-3 plus everyday-use staples;
# hand-curated, not copied from the reference's grade lists)
KANJI_COMMON = (
    "一二三四五六七八九十百千万円年月日時分週曜火水木金土本人今新古"
    "大中小上下左右前後内外高安多少長短明暗強弱早遅太細広狭深浅重軽"
    "山川田町村市区都道府県国州島海空陸地岩石砂泥池湖沼谷森林草花葉"
    "木竹米麦豆肉魚鳥犬猫馬牛羊虫貝雨雪風雲雷晴曇暑寒暖涼春夏秋冬朝"
    "昼夜晩夕方角丸形色白黒赤青緑黄茶紫点線面体円形球何誰此其彼是非"
    "行来帰出入立座歩走飛泳浮沈開閉始終止動静働休見聞言話読書写消置"
    "持取捨拾投打引押抜差上食飲作造建壊直曲切折貼塗洗拭掃除習覚忘思"
    "考知分解問答教学校生徒先師友達親子父母兄弟姉妹夫妻男女"
    "心手足目耳口鼻顔頭首肩腕指背腹腰膝声音楽歌絵画写真映画遊戯具"
    "気元病痛薬医者院室家屋部戸窓門庭道路橋駅車電汽船機械働銀行店"
    "買売金品物値段安高料理飯茶酒塩糖油味香服着脱帽靴傘袋箱紙筆墨"
    "字文章詩句語英和漢洋数算計測量図表地理歴史社会科理科実験工作"
    "春節祭礼神社寺仏様王様殿様姫軍兵士戦争平和勝負運動競争泣笑怒"
    "喜悲楽苦幸福不幸愛恋情熱冷静真偽正誤善悪美醜利害得失有無可否"
)
