"""Chinese text utilities for the evaluation stack.

The reference's Seed-TTS WER protocol (ref zipvoice/eval/wer/seedtts.py:
127-151, 238) post-processes ASR output with:

* ``zhconv.convert(text, "zh-cn")`` — traditional -> simplified;
* stripping all CJK + ASCII punctuation (``zhon.hanzi.punctuation`` +
  ``string.punctuation``, apostrophe kept);
* character-level splitting for ZH scoring.

This module provides offline equivalents.  ``traditional_to_simplified``
prefers the real ``zhconv`` package when installed and otherwise applies a
built-in single-character table covering the common traditional forms —
sufficient for ASR output, which is overwhelmingly simplified already (the
conversion is a safety net for occasional traditional characters Whisper/
Paraformer emit).
"""

from __future__ import annotations

import string

# CJK punctuation inventory (the zhon.hanzi punctuation set: full-width
# forms, CJK brackets/quotes, and stops).
ZH_PUNCTUATION = (
    "＂＃＄％＆＇（）＊＋，－／：；＜＝＞＠［＼］＾＿｀｛｜｝～｟｠｢｣､　"
    "、〃〈〉《》「」『』【】〔〕〖〗〘〙〚〛〜〝〞〟〰〾〿–—‘’‛“”„‟…‧﹏﹑﹔"
    "·！？｡。"
)

# Common traditional -> simplified single-character mappings.  Multi-char
# vocabulary-aware conversion (zhconv's locale dictionaries) is out of scope;
# for WER normalization the character table is what matters.
_T2S_PAIRS = (
    "愛爱礙碍罷罢備备筆笔畢毕邊边變变標标錶表別别賓宾並并佈布採采參参慚惭"
    "殘残燦灿倉仓蒼苍層层冊册測测產产嘗尝長长償偿廠厂場场車车徹彻塵尘陳陈"
    "稱称懲惩遲迟齒齿衝冲蟲虫籌筹綢绸醜丑處处觸触傳传瘡疮闖闯創创詞词辭辞"
    "聰聪從从湊凑竄窜錯错達达帶带貸贷擔担單单膽胆導导島岛燈灯鄧邓敵敌遞递"
    "點点電电墊垫釣钓調调疊叠諜谍頂顶訂订東东動动凍冻棟栋鬥斗獨独讀读賭赌"
    "斷断隊队對对噸吨頓顿奪夺墮堕鵝鹅額额惡恶餓饿兒儿爾尔餌饵發发罰罚閥阀"
    "礬矾煩烦範范販贩飯饭訪访紡纺飛飞誹诽廢废費费紛纷墳坟奮奋憤愤糞粪豐丰"
    "楓枫鋒锋風风瘋疯馮冯縫缝諷讽鳳凤膚肤輻辐撫抚輔辅賦赋復复負负婦妇縛缚"
    "該该鈣钙蓋盖幹干趕赶贛赣岡冈剛刚鋼钢綱纲崗岗個个鞏巩貢贡溝沟構构購购"
    "夠够估估孤孤古古穀谷顧顾僱雇颳刮關关觀观館馆慣惯貫贯廣广歸归龜龟規规"
    "軌轨詭诡櫃柜貴贵劊刽輥辊滾滚鍋锅國国過过駭骇韓韩漢汉號号閡阂鶴鹤賀贺"
    "轟轰鴻鸿紅红後后壺壶護护滬沪戶户華华畫画劃划話话懷怀壞坏歡欢環环還还"
    "緩缓換换喚唤瘓痪煥焕渙涣黃黄謊谎揮挥輝辉毀毁賄贿穢秽會会燴烩匯汇諱讳"
    "誨诲繪绘葷荤渾浑夥伙獲获貨货禍祸擊击機机積积飢饥蹟迹譏讥雞鸡績绩緝缉"
    "極极輯辑級级幾几薊蓟劑剂濟济計计記记際际繼继紀纪夾夹莢荚頰颊賈贾鉀钾"
    "價价駕驾殲歼監监堅坚箋笺間间艱艰緘缄繭茧檢检鹼碱揀拣減减薦荐檻槛鑒鉴"
    "踐践賤贱見见鍵键艦舰劍剑餞饯漸渐濺溅澗涧將将漿浆蔣蒋槳桨獎奖講讲醬酱"
    "膠胶澆浇驕骄嬌娇攪搅鉸铰矯矫僥侥腳脚餃饺繳缴絞绞轎轿較较稭秸階阶節节"
    "莖茎鯨鲸驚惊經经頸颈靜静鏡镜徑径痙痉競竞淨净糾纠廄厩舊旧駒驹舉举據据"
    "鋸锯懼惧劇剧鵑鹃絹绢傑杰潔洁結结誡诫屆届緊紧錦锦僅仅謹谨進进晉晋燼烬"
    "盡尽勁劲荊荆覺觉決决訣诀絕绝鈞钧軍军駿骏開开凱凯顆颗殼壳課课墾垦懇恳"
    "摳抠庫库褲裤誇夸塊块儈侩寬宽礦矿曠旷況况虧亏睏困捆捆擴扩闊阔蠟蜡臘腊"
    "萊莱來来賴赖藍蓝欄栏攔拦籃篮闌阑蘭兰瀾澜讕谰攬揽覽览懶懒纜缆爛烂濫滥"
    "撈捞勞劳澇涝樂乐鐳镭壘垒類类淚泪籬篱離离鯉鲤禮礼麗丽厲厉勵励礫砾歷历"
    "瀝沥隸隶倆俩聯联蓮莲連连鐮镰憐怜漣涟簾帘斂敛臉脸鏈链戀恋煉炼練练糧粮"
    "涼凉兩两輛辆諒谅療疗遼辽鐐镣獵猎臨临鄰邻鱗鳞凜凛賃赁齡龄鈴铃靈灵嶺岭"
    "領领餾馏龍龙聾聋嚨咙籠笼壟垄攏拢隴陇樓楼婁娄摟搂簍篓漏漏蘆芦盧卢顱颅"
    "廬庐爐炉亂乱倫伦輪轮論论蘿萝羅罗邏逻鑼锣籮箩騾骡駱骆絡络媽妈瑪玛碼码"
    "螞蚂馬马罵骂嗎吗買买麥麦賣卖邁迈脈脉瞞瞒饅馒蠻蛮滿满謾谩貓猫錨锚鉚铆"
    "貿贸麼么黴霉沒没鎂镁門门悶闷們们錳锰夢梦瞇眯謎谜彌弥覓觅冪幂綿绵麵面"
    "廟庙滅灭憫悯閩闽鳴鸣銘铭謬谬謀谋畝亩內内鈉钠難难撓挠腦脑惱恼鬧闹餒馁"
    "膩腻攆撵釀酿鳥鸟聶聂嚙啮鑷镊鎳镍檸柠獰狞寧宁擰拧濘泞鈕钮紐纽膿脓濃浓"
    "農农瘧疟諾诺歐欧毆殴嘔呕漚沤盤盘龐庞賠赔噴喷鵬鹏騙骗飄飘頻频貧贫蘋苹"
    "憑凭評评潑泼頗颇撲扑鋪铺樸朴譜谱臍脐齊齐騎骑豈岂啟启氣气棄弃訖讫牽牵"
    "釺钎鉛铅遷迁簽签謙谦錢钱鉗钳潛潜淺浅譴谴塹堑槍枪嗆呛牆墙薔蔷強强搶抢"
    "鍬锹橋桥喬乔僑侨翹翘竅窍竊窃欽钦親亲寢寝輕轻氫氢傾倾頃顷請请慶庆瓊琼"
    "窮穷趨趋區区軀躯驅驱齲龋顴颧權权勸劝卻却鵲鹊確确讓让饒饶擾扰繞绕熱热"
    "韌韧認认紉纫榮荣絨绒軟软銳锐閏闰潤润灑洒薩萨鰓鳃賽赛傘伞喪丧騷骚掃扫"
    "澀涩殺杀紗纱篩筛曬晒閃闪陝陕贍赡繕缮傷伤賞赏燒烧紹绍賒赊攝摄懾慑設设"
    "紳绅審审嬸婶腎肾滲渗聲声繩绳勝胜聖圣師师獅狮濕湿詩诗屍尸時时蝕蚀實实"
    "識识駛驶勢势適适釋释飾饰視视試试壽寿獸兽樞枢輸输書书贖赎屬属術术樹树"
    "豎竖數数帥帅雙双誰谁稅税順顺說说碩硕爍烁絲丝飼饲聳耸慫怂頌颂訟讼誦诵"
    "擻擞蘇苏訴诉肅肃雖虽隨随綏绥歲岁孫孙損损筍笋縮缩瑣琐鎖锁獺獭撻挞態态"
    "攤摊貪贪癱瘫灘滩壇坛譚谭談谈嘆叹湯汤燙烫濤涛絛绦討讨騰腾謄誊銻锑題题"
    "體体屜屉條条貼贴鐵铁廳厅聽听烴烃銅铜統统頭头禿秃圖图塗涂團团頹颓蛻蜕"
    "脫脱鴕鸵馱驮駝驼橢椭窪洼襪袜彎弯灣湾頑顽萬万網网韋韦違违圍围為为濰潍"
    "維维葦苇偉伟偽伪緯纬謂谓衛卫溫温聞闻紋纹穩稳問问甕瓮撾挝蝸蜗渦涡窩窝"
    "臥卧嗚呜鎢钨烏乌誣诬無无蕪芜吳吴塢坞霧雾務务誤误錫锡犧牺襲袭習习銑铣"
    "戲戏細细蝦虾轄辖峽峡俠侠狹狭廈厦嚇吓鍁锨鮮鲜纖纤鹹咸賢贤銜衔閒闲顯显"
    "險险現现獻献縣县餡馅羨羡憲宪線线廂厢鑲镶鄉乡詳详響响項项蕭萧囂嚣銷销"
    "曉晓嘯啸蠍蝎協协挾挟攜携脅胁諧谐寫写瀉泻謝谢鋅锌釁衅興兴洶汹鏽锈繡绣"
    "虛虚噓嘘須须許许敘叙緒绪續续軒轩懸悬選选癬癣絢绚學学勛勋詢询尋寻馴驯"
    "訓训訊讯遜逊壓压鴉鸦鴨鸭啞哑亞亚訝讶閹阉煙烟鹽盐嚴严顏颜閻阎艷艳厭厌"
    "硯砚彥彦諺谚驗验鴦鸯楊杨揚扬瘍疡陽阳癢痒養养樣样瑤瑶搖摇堯尧遙遥窯窑"
    "謠谣藥药爺爷頁页業业葉叶醫医銥铱頤颐遺遗儀仪蟻蚁藝艺億亿憶忆義义詣诣"
    "議议誼谊譯译異异繹绎蔭荫陰阴銀银飲饮隱隐櫻樱嬰婴鷹鹰應应纓缨瑩莹螢萤"
    "營营熒荧蠅蝇贏赢穎颖喲哟擁拥傭佣癰痈踴踊詠咏湧涌優优憂忧郵邮鈾铀猶犹"
    "遊游誘诱輿舆魚鱼漁渔娛娱與与嶼屿語语獄狱譽誉預预馭驭鴛鸳淵渊轅辕園园"
    "員员圓圆緣缘遠远願愿約约躍跃鑰钥嶽岳粵粤悅悦閱阅雲云鄖郧勻匀隕陨運运"
    "蘊蕴醞酝暈晕韻韵雜杂災灾載载攢攒暫暂贊赞贓赃髒脏鑿凿棗枣竈灶責责擇择"
    "則则澤泽賊贼贈赠紮扎軋轧鍘铡閘闸柵栅詐诈齋斋債债氈毡盞盏斬斩輾辗嶄崭"
    "棧栈戰战綻绽張张漲涨帳帐賬账脹胀趙赵蟄蛰轍辙鍺锗這这貞贞針针偵侦診诊"
    "鎮镇陣阵掙挣睜睁猙狰爭争幀帧鄭郑證证織织職职執执紙纸摯挚擲掷幟帜質质"
    "滯滞鐘钟終终種种腫肿眾众謅诌軸轴皺皱晝昼驟骤豬猪諸诸誅诛燭烛矚瞩囑嘱"
    "貯贮鑄铸築筑駐驻專专磚砖轉转賺赚樁桩莊庄裝装妝妆壯壮狀状錐锥贅赘墜坠"
    "綴缀諄谆濁浊茲兹資资漬渍蹤踪綜综總总縱纵鄒邹詛诅組组鑽钻"
    "裡里裏里於于鬆松乾干儘尽臺台颱台檯台製制誌志錄录簡简"
)

_T2S = {_T2S_PAIRS[i]: _T2S_PAIRS[i + 1] for i in range(0, len(_T2S_PAIRS), 2)}


def traditional_to_simplified(text: str) -> str:
    """Traditional -> simplified Chinese (zhconv when available, built-in
    character table otherwise)."""
    try:
        import zhconv  # type: ignore

        return zhconv.convert(text, "zh-cn")
    except ImportError:
        return "".join(_T2S.get(ch, ch) for ch in text)


def seedtts_normalize(text: str, lang: str) -> str:
    """Seed-TTS WER text normalization (ref eval/wer/seedtts.py:127-151):
    strip CJK+ASCII punctuation (keep apostrophes), collapse double spaces;
    ZH -> space-joined characters, EN -> lowercase."""
    for ch in ZH_PUNCTUATION + string.punctuation:
        if ch == "'":
            continue
        text = text.replace(ch, "")
    text = text.replace("  ", " ")
    if lang == "zh":
        return " ".join(list(text))
    if lang == "en":
        return text.lower()
    raise ValueError(f"unsupported lang: {lang}")
